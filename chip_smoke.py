#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once) and drives the port's serving and training paths on the card, raising
on any failure.  Phases, each printed as it ends:

  1. device         the card's name and power limit (nvidia-smi); each
                    library's build time and ptxas resources; fails if
                    ptxas serialised the flash or K8 kernels' wgmma
                    (C7515).
  2. kernels        K1-fwd (flash-attention forward) against its plain
                    PyTorch version on the same inputs, bf16 and fp32, at the
                    serving shapes and at gpt2-350m's NH=16 (its
                    speculative prefill, B=1, T=128); the bf16 forward
                    (K1-fwd, K3-fwd) at ragged T (1 .. 1000 around its
                    64-row tiles and K/V ring), KH 12/4/1, twice with
                    bitwise equal results; then kernel and plain times,
                    TFLOP/s, and the forward's registers, spills (a spill
                    fails) and shared memory.
  3. serve          GPT-2 124M (full width, seeded random weights, bf16)
                    through GenerationEngine: 8 greedy requests, chunked and
                    per-tick decode, launches == 12 x prefill dispatches
                    (K1-fwd) and 12 x (prefill dispatches + decode ticks)
                    (GELU); then TextEngine.
  4. xdevice        a small fp32 model through the engine on CUDA (kernel)
                    and on the CPU (plain version): same greedy tokens,
                    prefill logits within 1e-4.
  5. kernels-train  K2 (flash backward), K5/K6 (fused CE forward/backward)
                    and K7 (fused AdamW) against their plain versions at the
                    training shapes; K2 also at ragged T (1 .. 1000 around
                    its 64-row tiles), sm_scale 1/8 and 0.1, twice with
                    bitwise equal results; then kernel and plain times, and
                    K2's registers, shared memory and TFLOP/s.
  6. train          GPT-2 124M at full width and depth (fp32 masters, bf16
                    compute, B=8, T=1024, the synthetic token stream) for
                    12 steps through train/loop.train: finite, falling loss;
                    every kernel launched on every step in the designed
                    counts (a K2 launch is one call that runs its three
                    kernels: pre-pass, dK/dV, dQ); step ms, tok/s, MFU and
                    peak memory.
  7. xdevice-train  one training step of a small fp32 model (D=64, fused CE
                    route) on CUDA with the kernels and on the CPU with the
                    plain versions, from the same weights and tokens: loss,
                    all 16 grads and the updated params agree.
  8. kernels-gqa    K3-fwd and K3-bwd (GQA at kv width) against their plain
                    versions, NH=12, KH in {4, 1}, K3-bwd also at K2's
                    ragged T, sm_scale and repeatability cases; then times
                    at the GQA training shape.
  9. kernels-prefill K4 (continuation prefill) against its plain version
                    over an 8K cache whose tail past the chunk's frontier
                    is NaN, then times at the last chunk of an 8K prompt.
 10. train-gqa      GPT-2 124M with 4 kv heads (114,990,336 parameters),
                    full width and depth, through train/loop.train as in 6:
                    K3 instead of K1/K2 in every layer.
 11. serve-gqa      GPT-2 124M kv=4 at max_seq_len 8192, B=8, a 7680-token
                    prompt, greedy: chunked prefill (512: one K3-fwd chunk,
                    14 K4 chunks) and whole-prompt prefill, each for 1 and
                    128 new tokens; then an MHA chunked prefill (K1 + K4).
 12. xdevice-gqa    a small fp32 GQA model (NH=4, KH=2, D=64): one training
                    step and a chunked generate on CUDA (kernels) and on the
                    CPU (plain versions) agree.
 13. kernels-rope-window  K1-fwd, K2 and K3 with rope and the sliding-window
                    band against their plain versions (W in {1, 63, 64, 65,
                    1024}, T in {1000, 8192}; band-edge inputs that a band
                    moved by one key fails), K1-fwd without rope at T=7680
                    and K4 with the band at q_offset 7168 at the serving
                    shapes, then times at T=8192, W=1024 beside the band-aware
                    bound and SDPA with a band mask, and K1-fwd with the band
                    at the serve-window prompt (B=8, T=7680); the windowed K2
                    must take under half the full-causal K2's time; each
                    kernel's TFLOP/s and resources.
 14. kernels-headce K8 (fused head + CE) against its plain version at
                    ragged R (1 .. 8191 around its 64-row tiles), C 64 ..
                    1600, a ragged last vocab tile, strided views, targets
                    on the last real column, in the pad and out of range
                    (NaN), twice with bitwise equal results; views TMA
                    cannot map refused before a launch; then R in {8192,
                    16384} with times beside the bare cuBLAS product,
                    matmul + F.cross_entropy and cuBLAS + K5, TFLOP/s and
                    resources (a spill fails); loss and gradients through
                    it against the two-op route (K5/K6).
 15. train-window   GPT-2 124M at T=8192 with window 1024 and rope
                    (129,944,832 parameters), B=2, 12 steps through
                    train/loop.train as in 6 (rope and the band inside K1-fwd
                    and K2); then the full-causal control (W=0).
 16. train-headce   phase 6's run with ops/fused_head_ce.ENABLE set: K8 in
                    place of K5, 12 launches in 12 steps.
 17. serve-window   the rope + window model at max_seq_len 8192, B=8, a
                    7680-token prompt: generate whole (K1-fwd with the band)
                    and in 512-token chunks (K4 with the band), last-position
                    logits within 1e-3; generate_streaming (ring cache) for
                    32 new tokens beside the dense-cache run.
 18. xdevice-window small fp32 rope + window models (kv 2 and 1): a training
                    step and a chunked generate on CUDA and on the CPU agree.
 19. kernels-vit    K1-fwd and K2 at causal=False (vit mode's bidirectional
                    attention) against their plain versions at (B, T, NH) =
                    (64, 197, 12), (256, 197, 6), (256, 197, 12),
                    (8, 17, 2), (64, 65, 3), bf16 and fp32, twice with
                    bitwise equal results; times at the T=197 shapes by
                    events and by device time (torch.profiler; the
                    captures taken, and a census of 100 at the training
                    shape) beside the bound and SDPA's non-causal forward
                    and backward; K7 over ViT-B/16's 87,335,656 values
                    beside AdamW(fused=True).
 20. infer-vit      ViT-S/16 (seeded random weights, bf16, B=256) through
                    the infer CLI's function: 12 K1-fwd and 12 GELU
                    launches a forward, finite logits near the fp32 CPU forward's; images/s,
                    latency, MFU, peak memory.
 21. train-vit      ViT-B/16 (87,335,656 parameters) at full width and
                    depth, B=64, synthetic-imagenet (uint8, normalised on
                    the device), 12 steps through train/loop.train with
                    AdamW, wd 0.05, behind the prefetcher (pinned buffers,
                    side-stream copies) with the crop and flip in the
                    native imagepipe (which must load), EMA 0.9999, an
                    async checkpoint at step 6 and a Chrome trace of step
                    8: finite, falling loss; 12 K1-fwd, 12 K2, 1 K7 a step,
                    no K5, K6 or K8; step ms, images/s, MFU, peak memory,
                    the loader's ms a batch, the step's wait for it and the
                    traced step's busy share; then the same run with the
                    prefetcher off: the same losses, and its busy share.
 22. xdevice-vit    a small fp32 vit (T=65, 2 heads of 64, CLS pool): one
                    training step on CUDA and on the CPU, plain, with mixup
                    and with stochastic depth + head dropout: loss, every
                    gradient and the updated parameters agree.

 23. kernels-moe    K1-fwd, K2, K5 and K6 at the MoE training shapes
                    (gpt2-moe-8e at bench.py's B=24: attention B=24 T=1024
                    NH=12 causal, the loss at R=24,576 x 50,304) against
                    their plain versions, then times beside the bound, SDPA
                    and F.cross_entropy.
 24. train-moe      gpt2-moe-8e (521,197,824 parameters, E=8, top-2) at full
                    width and depth, bench.py's MoE row (B=24, T=1024,
                    Adafactor, moe_cap_factor 1.0), 12 steps through
                    train/loop.train: finite, falling loss; 12 K1-fwd, 12
                    K2, 1 K5, 1 K6 a step and no K7 or K8; step ms, tok/s,
                    sparse MFU, peak memory, the router's kept fraction, the
                    Adafactor state beside AdamW's m + v, and a device-time
                    breakdown of one step with the index/gather group.
 25. train-muon     phase 6's run with --optimizer muon (lr 0.02): finite,
                    falling loss, and no K7.
 26. serve-moe      gpt2-moe-8e in bf16 through GenerationEngine (8 greedy
                    requests; launches == 12 x prefill dispatches) and a
                    chunked generate() whose continuation chunks run K4;
                    prefill ms, decode tok/s, ms per new token.
 27. xdevice-moe    a small fp32 MoE model (E=4, top-2, cap 1.0, with drops):
                    an Adafactor and a Muon step and a chunked generate on
                    CUDA and on the CPU agree (the same router dst first);
                    moe_mlp's forward and backward on the card are bitwise
                    repeatable.
 28. kernels-remat  K1-fwd, K2, K5 and K6 at gpt2-124m-4k's training shapes
                    (B=4, T=4096 causal; the loss at R=16,384 x 50,304)
                    against their plain versions, then times beside the
                    bound, SDPA and F.cross_entropy.
 29. train-remat    gpt2-124m-4k (126,799,104 parameters), B=4, T=4096,
                    AdamW, 12 steps under remat False, True (selective) and
                    "full": step ms, tok/s, MFU, peak memory, launches a
                    step (K1-fwd/K2 12/12, 12/12, 24/12), the losses within
                    2^-8 of each other; one step's 16 gradients selective
                    against plain (rtol 5e-4, qkvb atol 2e-4) and the
                    selective peak below the plain one.
 30. train-vit-stream  ViT-B/16 at B=64 on 4 synthetic JPEG shards of 128
                    images made in the phase, RandAugment 2 @ 0.5, 12
                    steps, then evaluate_streaming over a val shard; the
                    native decoder where jpegpipe builds, else the loader's
                    PIL fallback (its ms labelled PIL's); left out only
                    where PIL does not import either (the decoder, or both
                    reasons, printed after the device phase).
 31. resume         GPT-2 124M, B=8, T=1024, prefetcher and async
                    checkpoints on: 12 steps straight against 6 (run_steps)
                    and a resume for 6 more; the losses, the final loss and
                    the step-12 checkpoint equal bit for bit.
 32. serve-paged    GPT-2 124M through the paged engine (257 pages: half
                    the dense-equivalent 513), phase serve's 8 prompts and a
                    second wave of 8, decode chunk 1 and 16: K1-fwd launches
                    == 12 x page-group prefills, every non-sink page back in
                    the pool, streams equal to the dense engine's with the
                    same prefill groups; tok/s, pool bytes, peak beside the
                    dense engine's.
 33. serve-int8     serve-gqa's model with the int8 KV cache, chunked (12
                    K3-fwd, 168 K4 over the dequantized cache) and whole,
                    beside the bf16 cache: prefill ms, ms per new token,
                    logits within 5e-2 (the chunked prefill's last
                    position, 4 decode steps after each prefill), cache
                    bytes under 0.6; then GPT-2
                    124M with w8 weights through the engine (tok/s, the
                    share of tokens equal to bf16's).
 34. serve-beam     GPT-2 124M beam search, B=4, T0=128, 32 new, 4 beams:
                    12 K1-fwd a call, beams=1 == greedy, the best beam's
                    fp32 log-prob at least greedy's.
 35. serve-spec     speculative decoding, gpt2-350m with a gpt2-124m draft
                    and with itself, B=1, T0=128, 128 new, K=4: stats, ms
                    per token beside generate, the first token unlike
                    target-only greedy and its logit gap.
 36. infer-vit-quant  ViT-S/16 and ViT-B/16 at B=256 through the infer
                    CLI's function with quant none, w8, w8a8: 12 K1-fwd a
                    forward, logits within 0.04 / 0.08 mean relative of
                    bf16's; images/s, latency, peak.

 37. kernels-families  K1-fwd and K2 at causal=False at the model families'
                    shapes: (B, T, NH) = (64, 50, 12) (the MAE encoder on
                    ViT-B/16), (64, 197, 8) (its 512-wide decoder) and
                    (64, 257, 16) (CLIP-L/14), against their plain versions
                    in bf16 and fp32, twice with bitwise equal results;
                    times by events and by device time beside SDPA and the
                    bound.
 38. pretrain-mae   vitrs-pretrain-mae-torch's loop on ViT-B/16 (encoder
                    768 x 12, decoder 512 x 4), B=64, 12 steps: finite,
                    falling loss, 16 K1-fwd + 16 K2 a step; step ms,
                    images/s, busy share, peak; then 4 steps of the trainer
                    warm-started from its encoder_final.bin.
 39. finetune-lora  vitrs-finetune-torch on a GPT-2 124M base written by
                    the port, rank 8, B=8, T=1024, 12 steps: 1,179,648
                    adapter parameters, the base unchanged and without
                    .grad, the adapter file, the merged checkpoint's logits
                    equal to apply_lora's; step ms and peak beside phase
                    train's.
 40. train-clip     clip-l-14 (24 x 1024, 16 heads, T=257), B=64, 8 steps of
                    clip_loss with adamw_tree: finite, falling loss, 24
                    K1-fwd + 24 K2 a step; ms, busy share, peak.
 41. quirks         quirks=True: a GPT-2 124M fp32 step (B=2, T=1024)
                    through dense attention, no flash or CE kernel; the
                    gpt-nano quirk loss and 16 gradients on the card
                    against the numpy oracle; a quirk generate with no
                    K1-fwd or K4 launch.
 42. bitexact       the bit-exact mode on the card: the loss and all 16
                    gradients == the scalar oracle (B=2, T=4, C=16, L=2).
 43. import-hf      the HF export -> convert round trip at GPT-2 124M and
                    ViT-B/16 geometry: the same arrays, and logits equal on
                    the card.

 44. ops            torch.library.opcheck (schema, fake tensor) of the nine
                    `vitrs::` ops on CUDA inputs at serving shapes; K1-fwd
                    at B=64 T=50 through its wrapper and through the op, by
                    events and by the host clock (the dispatcher's cost).
 45. serve-export   GPT-2 124M (bf16, B=4, T=1024) and ViT-B/16 (B=64)
                    through serving.export_forward (torch.export) and
                    ServedModel: logits equal to the eager forward's bit
                    for bit, 12 K1-fwd launches a call; artifact bytes,
                    export and load seconds, ms a call beside eager.
 46. serve-batching BatchingServer over the ViT-B/16 artifact (batch 64,
                    max_wait 5 ms): 512 requests from 8 threads, each result
                    equal to its row of the direct forward; images/s,
                    p50/p99 latency, batches.
 47. debug          utils/debug.checked passes a clean GPT-2 124M forward
                    and names the wte lookup when a row it reads is NaN;
                    debug_mode restores its flags.
 48. meshes         dp=2, fsdp=2 (2 ranks) and dp=2,fsdp=2 (4 ranks)
                    sharing cuda:0 over gloo (staged through host memory):
                    a small fp32 step against one process stepping the
                    whole batch (xdevice-dp), then GPT-2 124M (4 of its 12
                    layers, MESH_LAYERS), B=8, T=1024,
                    6 steps through train/loop.train (train-dp, -fsdp,
                    -hybrid): falling loss, each rank's launches a step
                    (K7 over half the parameters on the ZeRO-1 path), state
                    bytes as the shards predict, peaks, step ms (ranks
                    time-sliced on one card: not a scaling number).
 49. comm-nccl      a one-rank NCCL group on cuda:0 runs each collective of
                    parallel/collectives.py once; NCCL between cards stays
                    unverified on a one-card machine.
 50. kernels-tp-pp  K1-fwd and K2 (bf16) at the new per-rank shapes: B=8
                    T=1024 NH=6 causal (GPT-2 124M under tp=2), B=2 T=1024
                    NH=12 causal (a pipeline microbatch), B=64 T=197 NH=6
                    non-causal (ViT-B/16 under tp=2), B=4 T=1024 NH=12 and
                    NH=6 causal (gpt2-moe-8e's rows a rank under ep=2 and
                    ep=2,tp=2), against their plain versions;
                    times by events and device, SDPA, the bound.
 51. meshes-tp-pp   ranks sharing cuda:0 over gloo: the small fp32 model's
                    step under tp=2 (AdamW, Adafactor, Muon),
                    dp=2,tp=2,sp,vp, pp=2 (GPipe, 1F1B, interleaved v=2;
                    1F1B with Adafactor) and tp=2,pp=2 (AdamW, Adafactor)
                    against one process stepping the whole batch; then
                    GPT-2 124M (B=8, T=1024) under tp=2, dp=2,tp=2,sp,vp,
                    pp=2 1F1B mb=4, pp=2 interleaved v=2 mb=4 and tp=2,pp=2,
                    and ViT-B/16 (B=64) under tp=2, 6 steps each through
                    train/loop.train: falling loss, each rank's launches as
                    designed, state bytes as its slices predict, peaks, step
                    ms (time-sliced on one card: not a scaling number).
 52. kernels-cp     the ring attention's per-hop routes at the cp shapes
                    (bf16, B=4 T/cp=2048 NH=12 MHA and KH=4; B=2 T/cp=4096
                    W=1024 KH=4 and 12): K1-fwd / K3-fwd and K2 / K3-bwd on
                    the diagonal (causal), past (non-causal) and cut
                    (causal with the window on the rectangle the band
                    reaches, a query offset past the keys' end) hops
                    against their plain versions, the lse merge and the
                    summed hop gradients against the plain whole sequence;
                    times, SDPA, the bound; then rectangles at edge
                    geometries (rows and offsets off the 64 grid, KH 1 / 4 /
                    12, rows that see no key, bf16 and fp32).
 53. meshes-cp-ep   ranks sharing cuda:0 over gloo: the small fp32 model's
                    step under cp=2 (dense and banded AdamW, Adafactor),
                    ep=2 and ep=2,tp=2 (AdamW, Adafactor) against one
                    process; then, at 4 of their 12 layers, gpt2-124m-4k
                    (B=4, AdamW) and the train-window model (T=8192, B=2,
                    Adafactor: the banded ring) under cp=2, gpt2-moe-8e (B=8) under ep=2 (AdamW,
                    clip) and ep=2,tp=2 (Adafactor): the first batch's
                    fp32 gradient against one process (every leaf within
                    1e-4 of its L2 norm under cp, 2e-2 under ep), then 6
                    steps each: every rank's loss
                    equal and step 1's as one process's (rtol 1e-3),
                    launches and cut hops as designed (cp-window: 8 K3-fwd
                    and 8 K3-bwd a step on rank 1), no flash plain version
                    on the card, state bytes as sliced, peaks, step ms.
 54. kernels-head-dims  K1-fwd, K2, K3-fwd / K3-bwd and K4 at head dims
                    32, 128 and 256 (24, 6, 3 heads at C=768; K3 at 8, 2, 1
                    kv heads), each head dim its own library
                    (ops/_build.load(name, D)), against their plain
                    versions: edge rows T 1/37/200 (bf16 and fp32, MHA and
                    GQA, causal and full, each twice and bitwise equal),
                    B=8 T=1024 causal, B=64 T=197 non-causal, rope +
                    W=1024 at B=2 T=8192 (D=32, 128), K4 (S 1/37/200 in
                    bf16 and fp32; every chunk of the chunked generates
                    below at their batch, kv heads and cache; S=512 at
                    q_offset 7168; NaN tails), and at D=128 the ring's cut hop and rows that
                    see no key (gradients also within `grad_errors`, with
                    its one-term rounding allowance, `bwd_term_norms`);
                    times beside the plain version, SDPA and the bound;
                    registers and shared memory (a forward spill fails).
                    Each case draws its inputs from a generator seeded
                    from its own parameters (`hd_gen`).
 55. train-d128     GPT-2 124M at 6 heads of 128 (124,439,808 parameters),
                    B=8 T=1024, 12 steps through train/loop.train (12 K1-fwd
                    + 12 K2 a step) and the first batch's fp32 gradient
                    through the kernels against the dense route (every
                    leaf within 1e-4 of its L2 norm); then 2 kv heads with
                    rope + W=1024 at T=8192, B=2 (K3), its gradient on the
                    first row's 2048 tokens; no flash plain version on the
                    card.
 56. serve-d128     the 6 x 128 model through GenerationEngine (bf16, 8
                    requests, K1-fwd) and a chunked generate (768 tokens in
                    256-token chunks: K1-fwd + K4): prefill and decode ms;
                    fp32 greedy tokens, whole and chunked, equal to the
                    dense route's.
 57. train-d32, train-d256  24 x 32 and 3 x 256 as train-d128, 4 steps;
                    then 8 / 1 kv heads: 4 steps (K3) and a chunked
                    generate (K3-fwd + K4).
     kernels-head-dims also holds the ends: D = 8, 16, 384 and 512 (96,
                    48, 2 and 2 heads; 8, 8, 1, 1 kv heads; D = 512 at
                    C = 1024) as the others (no ViT shape; rope + W=1024 at
                    T=8192 at D = 16; rope + W=33 edge rows at D <= 16;
                    the cut hop at each), the exp bound beside the square
                    rows at D <= 16, and the D = 16 build's D = 1, 2 and 4
                    (16 heads, 4 kv heads): edge rows and K4's; and the
                    largest admitted D, 1024 (2 heads, 1 kv head), and 640,
                    the odd atom count (2 heads at gpt2-774m's C = 1280):
                    edge rows, B=8 T=1024 causal MHA and GQA, K4's edges.
 58. nano           gpt-nano (2 heads of 8): `cli.train --preset gpt-nano`
                    6 steps on the card (2 K1-fwd + 2 K2 + 1 K7 a step),
                    then fp32 greedy tokens through GenerationEngine equal
                    to the dense route's.
 59. train-d8, train-d16, train-d384, train-d512  GPT-2 124M's width at 96
                    x 8, 48 x 16 and 2 x 384, gpt2-350m's (24 layers) at
                    2 x 512, B=8 T=1024, 4 steps (L K1-fwd + L K2 a step)
                    and the first batch's fp32 gradient against the dense
                    route; GQA: at D = 16 the window model (8 kv heads,
                    rope, W=1024, T=8192, B=2, 12 steps, gradient on 2048
                    tokens), at 8 / 384 / 512 (8 / 1 / 1 kv heads) 4 steps
                    (K3) and the first batch's fp32 gradient; a chunked
                    generate of the GQA model at 16, 384 and 512 (K3-fwd
                    + K4).
 60. serve-d8       the 96 x 8 model as serve-d128: engine prefill, chunked
                    prefill through K4, decode, fp32 greedy tokens equal to
                    the dense route's.
 61. kernels-gelu   the GELU kernels (csrc/gelu.cu), forward and backward,
                    tanh and exact, against the eager chain of ops/basic.py
                    at the benchmark cells' activations ((64 * 1024, 3072),
                    (128 * 197, 3072), (256 * 197, 3072) bf16): the forward
                    bit for bit, the backward within one bf16 ulp, then each
                    form's times beside the byte bound (4 / 6 bytes an
                    element) and its share, the eager chain's time and
                    F.gelu's (its backward: aten.gelu_backward), and the
                    kernels' registers and spills from ptxas (a spill fails).

`python3 chip_smoke.py --phases a,b` runs only the named phases (after the
device phase) and prints no result lines.  It also runs the phases that
only run on request:
     bwd-seeds      D = 32's rope + W=1024 T=8192 backward (24 heads, and
                    8 kv heads) on HD_SEEDS seeds: the kernel and the plain
                    version against the unrounded fp32 function, and the
                    values past `grad_errors` with and without its
                    one-term rounding allowance (PERF.md §7).

Each phase that counts launches holds every kernel to its designed count,
GELU's two included (`gelu_fwd` / `gelu_bwd`, csrc/gelu.cu): one forward
a layer a forward pass (a training or inference forward, an engine
prefill pass or decode tick, a generate chunk or token; twice under
remat, whose backward runs the MLP's forward again) and one backward a
layer a backward pass, on the dense route as on the flash one.

Every kernel also gets a bound (the least time the card could take: the
larger of its operations over the card's peak for their type and its bytes
over the memory rate, counted for this run's inputs) and, where one
PyTorch call computes the same function, that call's time as a yardstick.
The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import collections
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

CSRC = "vitrs_tpu_torch/csrc/"
# the flash sources once per head dim (ops/_build.load(name, D)), the rest once
LIBS = (("flash_fwd", 64), ("flash_bwd", 64), "fused_ce", "fused_adamw",
        "fused_head_ce", ("flash_fwd", 32), ("flash_bwd", 32),
        ("flash_fwd", 128), ("flash_bwd", 128), ("flash_fwd", 256),
        ("flash_bwd", 256), ("flash_fwd", 16), ("flash_bwd", 16),
        ("flash_fwd", 384), ("flash_bwd", 384), ("flash_fwd", 512),
        ("flash_bwd", 512), ("flash_fwd", 640), ("flash_bwd", 640),
        ("flash_fwd", 1024), ("flash_bwd", 1024), "gelu")
# NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores, fp32
# outside them, device memory
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_S = 3.35e12
# exponentials a second on the special function units: 16 ex2 a clock an
# SM x 132 SMs at the 1.83 GHz that the tensor cores' 989 TFLOP/s assume
# (the bound of the flash kernels at D <= 16: one exp a (query, key) pair)
EX2_PER_S = 16 * 132 * 1.83e9
NH, D, C = 12, 64, 768           # GPT-2 124M attention geometry


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, kind, nbytes):
    """(bound_ms, bound_by): the larger of flops over the card's peak for
    their type and nbytes over its memory rate."""
    ops_ms = flops / PEAK_FLOPS[kind] * 1e3
    mem_ms = nbytes / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def attn_pairs(tq, q_off, keys, causal, window=0):
    """(query, key) pairs attention computes: each of tq rows at positions
    p = q_off.. sees the keys j <= p of the `keys` there are, and under a
    sliding window only those with j > p - window (so a row past the keys'
    end sees the keys its band still reaches); all `keys` non-causal."""
    if not causal:
        return tq * keys
    return sum(max(0, min(p, keys - 1) - max(p - window + 1 if window else 0,
                                             0) + 1)
               for p in range(q_off, q_off + tq))


def fwd_flops(B, tq, q_off, keys, causal=True, window=0):
    """Operations of a flash forward: 2 products of 2*D flops per (query,
    key) pair; the TFLOP/s each K1-fwd/K3-fwd/K4 time is printed with."""
    return 4 * B * NH * D * attn_pairs(tq, q_off, keys, causal, window)


def bwd_flops(B, T, window=0):
    """Operations of a causal flash backward: 5 products of 2*D flops per
    (query, key) pair; the TFLOP/s each K2/K3-bwd time is printed with."""
    return 10 * B * NH * D * attn_pairs(T, 0, T, True, window)


def sdpa(q, k, v, nh, kh, causal=True, mask=None):
    """One PyTorch call computing the flash forward at any head dim (a
    yardstick only)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        heads(q, nh), heads(k, kh), heads(v, kh), attn_mask=mask,
        is_causal=causal and mask is None, enable_gqa=kh != nh)


def sdpa_bwd(q, k, v, do, nh, kh, causal=True, mask=None):
    """A closure running the backward of `sdpa` (a yardstick only)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, nh, kh, causal, mask)
    return lambda: torch.autograd.grad(out, leaves, heads(do, nh),
                                       retain_graph=True)


def fwd_bound(B, nh, kh, d, tq, q_off, keys, es, causal=True, window=0,
              rope=False):
    """(flops, bound) of a flash forward at head dim d: 2 products of 2 d
    flops per visible (query, key) pair; reads q, the k/v rows it needs
    (from the first row the band reaches) and under rope the fp32 (T, d/2)
    cos and sin rows of its positions; writes out and lse."""
    flops = 4 * B * nh * d * attn_pairs(tq, q_off, keys, causal, window)
    kv_rows = min(q_off + tq, keys) if causal else keys
    if causal and window:
        kv_rows -= max(0, q_off - window + 1)
    nbytes = (2 * B * tq * nh * d * es + 2 * B * kv_rows * kh * d * es
              + B * nh * tq * 4 + ((q_off + tq) * d * 4 if rope else 0))
    return flops, bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def bwd_bound(B, nh, kh, d, T, es, causal=True, window=0, rope=False):
    """(flops, bound) of a flash backward at head dim d: 5 products (s, dp,
    dv, dk, dq) of 2 d flops per visible pair; reads q, k, v, out, do and
    lse (and the rope table), writes dq, dk, dv."""
    flops = 10 * B * nh * d * attn_pairs(T, 0, T, causal, window)
    nbytes = (4 * B * T * nh * d * es + 4 * B * T * kh * d * es
              + B * nh * T * 4 + (T * d * 4 if rope else 0))
    return flops, bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def bwd_resources(rope=False):
    """{kernel: registers per thread, spill bytes, shared memory per block,
    threads} of the bf16 K2/K3-bwd kernels as built (the pre-pass, dK/dV,
    dQ; csrc/flash_bwd.cu's vitrs_flash_bwd_attrs), at sm_scale 1/8."""
    import ctypes
    from vitrs_tpu_torch.ops import _build
    fn = _build.load("flash_bwd", D).lib.vitrs_flash_bwd_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    res = {}
    for i, name in enumerate(("prep", "dkv", "dq")):
        out = (ctypes.c_int * 5)()
        rc = fn(i, int(rope), 0, ctypes.cast(out, ctypes.c_void_p))
        check(rc == 0, f"vitrs_flash_bwd_attrs({name}): CUDA error {rc}")
        res[name] = dict(registers=out[0], spill_bytes=out[1],
                         smem_bytes=out[2] + out[3], threads=out[4])
    return res


def fwd_resources(rope=False, band=False):
    """{kernel: registers per thread, spill bytes, shared memory per block,
    threads} of the bf16 K1-fwd/K3-fwd/K4 kernels as built (the main
    kernel's rope/band instance and, under rope, the k pre-pass;
    csrc/flash_fwd.cu's vitrs_flash_fwd_attrs); fails on a spill."""
    import ctypes
    from vitrs_tpu_torch.ops import _build
    fn = _build.load("flash_fwd", D).lib.vitrs_flash_fwd_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    res = {}
    for i, name in ((1, "main"), (0, "rope_k")):
        if i == 0 and not rope:
            continue
        out = (ctypes.c_int * 5)()
        rc = fn(i, int(rope), int(band), ctypes.cast(out, ctypes.c_void_p))
        check(rc == 0, f"vitrs_flash_fwd_attrs({name}): CUDA error {rc}")
        res[name] = dict(registers=out[0], spill_bytes=out[1],
                         smem_bytes=out[2] + out[3], threads=out[4])
        check(out[1] == 0, f"flash forward {name} (rope={rope}, band={band}) "
              f"spills {out[1]} bytes a thread")
    return res


def print_fwd_rate(tag, name, ms, flops, res=None):
    rsc = "; ".join(f"{k} {v['registers']} registers, {v['spill_bytes']} B "
                    f"spilled, {v['smem_bytes']} B shared, {v['threads']} "
                    f"threads" for k, v in (res or {}).items())
    print(f"[{tag}] {name}: {flops / ms / 1e9:.1f} TFLOP/s on the two-product "
          f"count" + (f"; {rsc}" if rsc else ""))


def print_bwd_rate(tag, name, ms, flops, res):
    print(f"[{tag}] {name}: {flops / ms / 1e9:.1f} TFLOP/s on the five-product "
          f"count; " + "; ".join(
              f"{k} {v['registers']} registers, {v['spill_bytes']} B spilled, "
              f"{v['smem_bytes']} B shared, {v['threads']} threads"
              for k, v in res.items()))


def bwd_edge_cases(tag, KHs, gen):
    """K2 (KH = NH, flash_bwd_cuda) or K3-bwd (flash_gqa_bwd_cuda) in bf16
    against the plain version at T in {1, 63, 64, 65, 127, 128, 129, 1000}
    (around the 64-row tiles), causal and not, at sm_scale 1/8 (s scaled in
    fp32) and 0.1 (q^ from the pre-pass), and with rope and the band (W=65)
    at T=1000, sm_scale 0.1; 2e-2 abs + rel as every K2 check.  Each case
    runs twice, and the two results must be the same bits (no atomics).
    Returns the largest error."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    cases = [(T, causal, scale, 0, False)
             for T in (1, 63, 64, 65, 127, 128, 129, 1000)
             for causal in (True, False) for scale in (0.125, 0.1)]
    cases.append((1000, True, 0.1, 65, True))
    worst = 0.0
    for KH in KHs:
        errs = []
        for T, causal, scale, W, rope in cases:
            q, do = (torch.randn(2, T, C, generator=gen, device="cuda").bfloat16()
                     for _ in range(2))
            k, v = (torch.randn(2, T, KH * D, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            args = (NH, KH, causal, scale, W, rope)
            out, lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
            if KH == NH:
                got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal,
                                                scale, W, rope) for _ in range(2))
            else:
                got, again = (FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
                              for _ in range(2))
            want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
            torch.cuda.synchronize()
            where = (f"KH={KH} T={T} causal={int(causal)} sm_scale={scale} W={W} "
                     f"rope={int(rope)}")
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(a, b), f"{where}: {name} differs between two "
                      f"calls")
                d = (a.float() - c.float()).abs()
                bad = ((d > 2e-2 + 2e-2 * c.float().abs()).sum().item()
                       + (~torch.isfinite(a)).sum().item())
                check(bad == 0, f"{where}: {bad} {name} values beyond 2e-2")
                errs.append(d.max().item())
        worst = max(worst, *errs)
        print(f"[{tag}] KH={KH}: {len(cases)} ragged-T / sm_scale / rope cases "
              f"within 2e-2 (max_abs_err {max(errs):.3e}), each bitwise equal "
              f"over two calls")
    return worst


def fwd_edge_cases(tag, gen):
    """The bf16 forward (K1-fwd at KH = NH, else K3-fwd) against the plain
    version at T in {1, 63, 64, 65, 127, 128, 129, 1000} (around the 64-row
    tiles and the K/V ring; causal frontiers that end mid-tile), KH in
    {12, 4, 1}, causal and full; out as `out_errors`, lse 1e-4.  Each case
    runs twice, and the two results must be the same bits.  Returns the
    largest out error."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    worst, n = 0.0, 0
    for KH in (NH, 4, 1):
        for T in (1, 63, 64, 65, 127, 128, 129, 1000):
            for causal in (True, False):
                qkv = torch.randn(2, T, C + 2 * KH * D, generator=gen,
                                  device="cuda").bfloat16()
                q, k, v = FG.split_gqa(qkv, NH, KH)
                if KH == NH:
                    run = lambda: FA.flash_fwd_cuda(q, k, v, NH, causal, 0.125)
                else:
                    run = lambda: FG.flash_gqa_fwd_cuda(q, k, v, NH, KH, causal,
                                                        0.125)
                (out, lse), (out2, lse2) = run(), run()
                ref, ref_lse = FG.flash_gqa_fwd_plain(q, k, v, NH, KH, causal,
                                                      0.125)
                torch.cuda.synchronize()
                where = f"KH={KH} T={T} causal={int(causal)}"
                check(torch.equal(out, out2) and torch.equal(lse, lse2),
                      f"forward {where}: two calls differ")
                bad, err, _ = out_errors(out, ref)
                check(bad == 0, f"forward {where}: {bad} out values beyond "
                      f"tolerance")
                lse_err = (lse - ref_lse).abs().max().item()
                check(lse_err <= 1e-4, f"forward {where}: lse err {lse_err}")
                worst = max(worst, err)
                n += 1
    print(f"[{tag}] bf16 forward: {n} ragged-T cases (KH 12/4/1, causal and "
          f"full) within tolerance (max_abs_err {worst:.3e}), each bitwise "
          f"equal over two calls")
    return worst


def out_limit(got, want, rows=True):
    """`out_errors`' bf16 bound, elementwise: 2^-7 max(|got|, |want|) +
    2^-6 max(rms, row rms), rms that of want, row rms that of want's row
    (one position, every channel); rows=False drops the row rms."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt()
    size = (w.square().mean(-1, keepdim=True).sqrt().clamp(min=rms)
            if rows else rms)
    return 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 2.0 ** -6 * size


def out_errors(got, want, rows=True):
    """(elements beyond tolerance, max_abs_err, rms of want) of a flash
    forward's output (K1-fwd, K3-fwd, K4: one kernel) against its plain
    version.
      bf16: |d| <= 2^-7 max(|got|, |want|) + 2^-6 max(rms, row rms)
            (`out_limit`).  Each side rounds one fp32 result to bf16, and
            ulp(x) <= 2^-7 |x|.  Before that, p rounds to bf16 against the
            kernel's running max but the plain version's final max:
            relative errors of 2^-9 per term, whose weighted sum over a
            row's keys stays near 2^-9 of that row's output size.  The
            first causal rows (and a band's) see few keys, so their
            outputs are several times the tensor's rms, and there a value
            near 0 can move by 1e-3 (on the card: a row with 68 keys of a
            T=8192 band, kernel and plain version 1.3e-3 apart, the plain
            version the further from fp64); rows=False counts what the
            tensor's rms alone would reject.  The rms term follows the
            output's own size (about 3e-4 at 7K keys), so a dropped kv tile
            or a frontier moved by a few keys, which move the output by
            percents of its rms, fail.
      fp32: 1e-5 abs + rel (only the summation order differs)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    if got.dtype == torch.bfloat16:
        lim = out_limit(got, want, rows)
    else:
        lim = 1e-5 + 1e-5 * w.abs()
    return (d > lim).sum().item(), d.max().item(), rms


def out_share(got, want, rows=True):
    """The largest |got - want| as a share of `out_errors`' bf16 bound."""
    d = (got.float() - want.float()).abs()
    return (d / out_limit(got, want, rows)).max().item()


def heads(t, h):
    """(B, T, h*d) -> (B, h, T, d) view, the layout of PyTorch's SDPA."""
    return t.unflatten(-1, (h, t.shape[-1] // h)).transpose(1, 2)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)                  # as nvidia-smi gives it: name, power limit
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from vitrs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.load_all(LIBS)        # one nvcc per source, in parallel
    print(f"[device] built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, lib in libs.items():
        print(f"[device] {name}: {lib.path} ({lib.build_seconds:.3f} s)")
        for line in lib.log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling", "wgmma")):
                print(f"[device] ptxas: {line.strip()}")
    # the wgmma kernels must keep their pipeline: ptxas serialises every
    # wgmma (warning C7515) when an accumulator is touched in flight
    for name, lib in libs.items():
        if name == "fused_head_ce" or (isinstance(name, tuple)
                                       and name[0].startswith("flash")):
            check(lib.log, f"{name}: no ptxas log kept beside the library")
            check("C7515" not in lib.log, f"{name}: ptxas serialised wgmma "
                  f"(C7515)")
    return smi


def phase_kernels():
    """K1-fwd vs plain at NH=12, D=64, C=768, B=4, T in {37 .. 1024}:
    one q tile, several, and ragged ends; then at gpt2-350m's NH=16
    (C=1024), causal: serve-spec's prefill (B=1, T=128) and ragged T
    beside it, each call twice and the same bits.  Tolerances: out as
    `out_errors`; lse 1e-4 bf16, 1e-5 fp32 (both sum the same fp32 p, in
    another order)."""
    from vitrs_tpu_torch.ops.flash_attention import flash_fwd_cuda, flash_fwd_plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype, lse_tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-5)):
        for T in (37, 128, 512, 1000, 1024):
            qkv = torch.randn(4, T, 3 * C, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(C, dim=-1)
            out, lse = flash_fwd_cuda(q, k, v, NH, True, 0.125)
            ref, ref_lse = flash_fwd_plain(q, k, v, NH, True, 0.125)
            torch.cuda.synchronize()
            bad, err, rms = out_errors(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[kernels] {str(dtype)[6:]:8s} T={T:4d} out max_abs_err "
                  f"{err:.3e} (rms {rms:.3e}) lse max_abs_err {lse_err:.3e}")
            check(torch.isfinite(out).all().item(), f"non-finite out at T={T}")
            check(bad == 0, f"{dtype} T={T}: {bad} out elements beyond "
                  f"tolerance")
            check(lse_err <= lse_tol, f"{dtype} T={T}: lse err {lse_err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        nh16 = 16
        for B, T in ((1, 128), (2, 37), (2, 1000)):
            qkv = torch.randn(B, T, 3 * nh16 * D, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.split(nh16 * D, dim=-1)
            (out, lse), (out2, lse2) = (flash_fwd_cuda(q, k, v, nh16, True,
                                                       0.125)
                                        for _ in range(2))
            ref, ref_lse = flash_fwd_plain(q, k, v, nh16, True, 0.125)
            torch.cuda.synchronize()
            where = f"{dtype} NH=16 B={B} T={T}"
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"{where}: two calls differ")
            bad, err, rms = out_errors(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[kernels] {str(dtype)[6:]:8s} NH=16 B={B} T={T:4d} out "
                  f"max_abs_err {err:.3e} (rms {rms:.3e}) lse max_abs_err "
                  f"{lse_err:.3e}; bitwise equal over two calls")
            check(bad == 0, f"{where}: {bad} out elements beyond tolerance")
            check(lse_err <= lse_tol, f"{where}: lse err {lse_err}")
            worst[dtype] = max(worst[dtype], err)
    worst[torch.bfloat16] = max(worst[torch.bfloat16], fwd_edge_cases("kernels", gen))
    times = {}
    for T in (128, 512, 1024):
        qkv = torch.randn(8, T, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(C, dim=-1)
        # plain, kernel, kernel, plain: the halves of each pair see the same card
        p1 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        k1 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        k2 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        p2 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        lib = cuda_ms(lambda: sdpa(q, k, v, NH, NH))
        flops = fwd_flops(8, T, 0, T)
        times[T] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                        library_ms=lib, tflops=flops / ((k1 + k2) / 2) / 1e9)
        print(f"[kernels] time bf16 B=8 T={T:4d} NH=12 causal: kernel "
              f"{k1:.4f}/{k2:.4f} ms ({times[T]['tflops']:.1f} TFLOP/s), "
              f"plain {p1:.4f}/{p2:.4f} ms, SDPA {lib:.4f} ms")
    bound_ms, by = fwd_bound(8, NH, NH, D, 1024, 0, 1024, 2)[1]
    rsc = fwd_resources()
    res = dict(max_abs_err=worst[torch.bfloat16], **times[1024],
               bound_ms=bound_ms, bound_by=by, resources=rsc,
               shape="bf16 B=8 T=1024 NH=12 D=64 causal")
    print(f"[kernels] K1-fwd bound {bound_ms:.4f} ms ({by})")
    print_fwd_rate("kernels", "K1-fwd", res["ms"], fwd_flops(8, 1024, 0, 1024), rsc)
    return res


def phase_serve(smi):
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data.tokenizer import ByteBPETokenizer
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.serving_gen import GenerationEngine, TextEngine

    cfg = get_config("gpt2-124m", dtype="bfloat16")
    check(P.num_parameters(cfg) == 124_439_808, "gpt2-124m parameter count")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v.to("cuda") for k, v in params.items()}
    rng = np.random.default_rng(0)
    lengths = (5, 37, 128, 300, 511, 700, 900, 960)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    def serve(chunk):
        eng = GenerationEngine(params, cfg, max_slots=8, max_len=1024,
                               prompt_buckets=(128, 512, 1024),
                               decode_chunk=chunk)
        for p in prompts:
            eng.submit(p, max_new=32)
        reset_counts()
        t0 = time.perf_counter()
        eng._admit()                       # the prefill passes, timed alone
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = dict(eng.run())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        # K1-fwd a layer a prefill pass; GELU a layer a prefill pass and a
        # decode tick
        L, passes = cfg.num_layers, eng.prefill_dispatches
        want = designed(flash_fwd=L * passes,
                        gelu_fwd=L * (passes + eng.decode_ticks))
        check(counts["flash_fwd"] > 0 and counts == want,
              f"[serve] chunk {chunk}: launches {counts} != designed {want}")
        return eng, outs, counts, (t1 - t0) * 1e3, 8 * 32 / (t2 - t1)

    serve(16)                                  # warm-up: cuBLAS, allocator
    eng, outs16, counts, prefill_ms, tok_s = serve(16)
    _, outs1, counts1, prefill_ms1, tok_s1 = serve(1)
    launches, launches1 = counts["flash_fwd"], counts1["flash_fwd"]
    for i, n in enumerate(lengths):
        check(len(outs16[i]) == n + 32, f"request {i}: length {len(outs16[i])}")
        check(np.array_equal(outs16[i], outs1[i]), f"request {i}: chunk 16 != 1")
        gen = outs16[i][n:]
        check(((gen >= 0) & (gen < cfg.vocab_size)).all(), f"request {i}: ids")
    # full-sequence logits through the model forward: finite
    seq = torch.as_tensor(outs16[7][None], device="cuda")
    logits = M.gpt_forward(eng.params, seq, cfg)
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    print(f"[serve] gpt2-124m bf16, 8 requests x 32 new, prompts {lengths}")
    print(f"[serve] chunk 16: {eng.prefill_dispatches} prefill dispatches, "
          f"{eng.decode_ticks} decode ticks, {launches} K1-fwd and "
          f"{counts['gelu_fwd']} GELU launches, prefill {prefill_ms:.3f} ms, "
          f"decode {tok_s:.1f} tok/s  ({smi})")
    print(f"[serve] chunk 1: {launches1} K1-fwd and {counts1['gelu_fwd']} "
          f"GELU launches, prefill {prefill_ms1:.3f} ms, decode "
          f"{tok_s1:.1f} tok/s, same tokens")

    tok = ByteBPETokenizer()
    # the byte tokenizer has 257 ids: a model of that vocab, same trunk
    tcfg = cfg.replace(vocab_size=tok.vocab_size)
    tparams = dict(params, wte=params["wte"][:tok.vocab_size])
    te = TextEngine(tparams, tcfg, tok, max_slots=2, max_len=256,
                    decode_chunk=8)
    texts = te.generate(["Once upon a time", "The H100 says"], max_new=16)
    check(len(texts) == 2 and all(isinstance(t, str) for t in texts),
          "TextEngine output")
    print(f"[serve] TextEngine: {texts!r}")
    return launches, prefill_ms, tok_s, counts


def phase_xdevice():
    """The engine on CUDA (kernel, fp32 instance) and on the CPU (plain
    version) with the same fp32 weights: same greedy tokens, prefill logits
    within 1e-4 (fp32 sums in other orders; TF32 off)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.serving_gen import GenerationEngine

    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=128, max_seq_len=64)
    params = P.init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 17, 40, 55)]
    outs = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        eng = GenerationEngine({k: v.to(dev) for k, v in params.items()},
                               cfg, max_slots=2, max_len=64,
                               prompt_buckets=(16, 32, 64), decode_chunk=4)
        for p in prompts:
            eng.submit(p, max_new=8)
        outs[dev] = dict(eng.run())
        L, passes = cfg.num_layers, eng.prefill_dispatches
        want = (designed(flash_fwd=L * passes,
                         gelu_fwd=L * (passes + eng.decode_ticks))
                if dev == "cuda" else designed())
        check(read_counts() == want, f"xdevice: the {dev} engine's launches "
              f"{read_counts()} != designed {want}")
    for i in range(len(prompts)):
        check(np.array_equal(outs["cuda"][i], outs["cpu"][i]),
              f"xdevice: request {i} tokens differ")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 50)))
    lg = {}
    for dev in ("cuda", "cpu"):
        caches = G.init_kv_cache(cfg, 2, 64, device=dev)
        pp = M.prepare_params({k: v.to(dev) for k, v in params.items()}, cfg)
        lg[dev] = G.forward_with_cache(pp, toks.to(dev), caches, 0, cfg)[0].cpu()
    err = (lg["cuda"] - lg["cpu"]).abs().max().item()
    print(f"[xdevice] fp32 L=2 C=128: tokens equal on cuda and cpu; "
          f"prefill logits max_abs_err {err:.3e}")
    check(err <= 1e-4, f"xdevice: prefill logits differ by {err}")



def timed_pair(kernel, plain, iters=20, warmup=3, plain_iters=None):
    """(kernel ms, plain ms): each the mean of two cuda_ms runs, in the
    order plain, kernel, kernel, plain, so both halves see the same card.
    plain_iters: the plain version's own count (after one warm-up call),
    for plain versions that take tens of ms."""
    pa = (iters, warmup) if plain_iters is None else (plain_iters, 1)
    p1, k1, k2, p2 = (cuda_ms(f, *a) for f, a in ((plain, pa),
                                                  (kernel, (iters, warmup)),
                                                  (kernel, (iters, warmup)),
                                                  (plain, pa)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def phase_kernels_train():
    """K2, K5, K6 and K7 against their plain versions, then times at the
    training shapes.  Tolerances (as tests/test_torch_train_cuda.py):
      K2 bf16 2e-2 abs + rel: p and ds round to bf16 before their products
         in both versions, and the fp32 sums run in other orders, which can
         flip a rounding (2^-8 relative);  K2 fp32 1e-4;
      K5 lse 1e-4 abs (fp32 logsumexp over 50257 columns, other order),
         picked exact (a copy);
      K6 2^-8 relative + 1e-6 abs (one bf16 ulp: the same fp32 formula,
         expf against torch.exp);
      K7 rtol 2e-6, atol 1e-9 (the same fp32 operations in the same
         order)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    gen = torch.Generator(device="cuda").manual_seed(2)
    import torch.nn.functional as F
    res = {}
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for T in (37, 128, 512, 1000, 1024):
            for causal in (True, False):
                qkv = torch.randn(4, T, 3 * C, generator=gen, device="cuda").to(dtype)
                out, lse = FA.flash_attention_fwd(qkv, NH, causal)
                do = torch.randn(4, T, C, generator=gen, device="cuda").to(dtype)
                q, k, v = qkv.split(C, dim=-1)
                got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, 0.125)
                want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, causal, 0.125)
                torch.cuda.synchronize()
                errs = []
                for name, a, b in zip(("dq", "dk", "dv"), got, want):
                    check(torch.isfinite(a).all().item(), f"K2 {name} non-finite")
                    d = (a.float() - b.float()).abs()
                    bad = (d > tol + tol * b.float().abs()).sum().item()
                    check(bad == 0, f"K2 {dtype} T={T} causal={causal}: {bad} "
                          f"{name} values beyond {tol}")
                    errs.append(d.max().item())
                print(f"[kernels-train] K2 {str(dtype)[6:]:8s} T={T:4d} "
                      f"causal={int(causal)} max_abs_err dq/dk/dv "
                      f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
                if dtype == torch.bfloat16:
                    worst = max(worst, *errs)
    worst = max(worst, bwd_edge_cases("kernels-train", (NH,), gen))
    qkv = torch.randn(8, 1024, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_fwd(qkv, NH, True)
    do = torch.randn(8, 1024, C, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(C, dim=-1)
    km, pm, raw = timed_pair(
        lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True, 0.125),
        lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, 0.125))
    lib = cuda_ms(sdpa_bwd(q, k, v, do, NH, NH))
    bms, by = bwd_bound(8, NH, NH, D, 1024, 2)[1]
    print(f"[kernels-train] K2 time bf16 B=8 T=1024 NH=12 causal: kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"SDPA backward {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    rsc, flops = bwd_resources(), bwd_flops(8, 1024)
    print_bwd_rate("kernels-train", "K2", km, flops, rsc)
    res["flash_bwd"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                            bound_ms=bms, bound_by=by, library_ms=lib,
                            tflops=flops / km / 1e9, resources=rsc,
                            shape="bf16 B=8 T=1024 NH=12 D=64 causal")

    R, V = 8192, 50257
    Vp = CE.pad_vocab(V)
    logits = (3 * torch.randn(R, Vp, generator=gen, device="cuda")).to(torch.bfloat16)
    targets = torch.randint(0, V, (R,), generator=gen, device="cuda")
    g = torch.full((R,), 1.0 / R, device="cuda")
    lse, picked = CE.ce_fwd_cuda(logits, targets, V)
    want_lse, want_picked = CE.ce_fwd_plain(logits, targets, V)
    d = CE.ce_bwd_cuda(logits, targets, lse, g, V)
    want_d = CE.ce_bwd_plain(logits, targets, lse, g, V)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    pick_err = (picked - want_picked).abs().max().item()
    derr = (d.float() - want_d.float()).abs()
    bad = (derr > 1e-6 + 2 ** -8 * want_d.float().abs()).sum().item()
    check(lse_err <= 1e-4 and pick_err == 0.0,
          f"K5: lse err {lse_err}, picked err {pick_err}")
    check(bad == 0, f"K6: {bad} dlogits values beyond one bf16 ulp")
    check(bool((d[:, V:] == 0).all()), "K6: pad columns not 0")
    print(f"[kernels-train] K5 R={R} Vp={Vp} bf16: lse max_abs_err "
          f"{lse_err:.3e}, picked {pick_err:.1e}; K6 dlogits max_abs_err "
          f"{derr.max().item():.3e}")
    km, pm, raw = timed_pair(lambda: CE.ce_fwd_cuda(logits, targets, V),
                             lambda: CE.ce_fwd_plain(logits, targets, V))
    # the real V columns are read (pad columns are masked), targets int64;
    # about 4 fp32 operations per logit (max, subtract, exp, add)
    lib = cuda_ms(lambda: F.cross_entropy(logits[:, :V], targets,
                                          reduction="none"))
    bms, by = bound(4 * R * V, "fp32", R * V * 2 + R * 8 + 2 * R * 4)
    print(f"[kernels-train] K5 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, F.cross_entropy {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    shape = f"bf16 R={R} Vp={Vp} real_vocab={V}"
    res["ce_fwd"] = dict(max_abs_err=lse_err, ms=km, plain_ms=pm,
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         shape=shape)
    km, pm, raw = timed_pair(lambda: CE.ce_bwd_cuda(logits, targets, lse, g, V),
                             lambda: CE.ce_bwd_plain(logits, targets, lse, g, V))
    # reads the real columns, lse, g and targets, writes all Vp columns;
    # about 5 fp32 operations per logit; no single PyTorch call computes it
    bms, by = bound(5 * R * V, "fp32", R * V * 2 + R * Vp * 2 + R * 16)
    print(f"[kernels-train] K6 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, bound {bms:.4f} ms ({by})")
    res["ce_bwd"] = dict(max_abs_err=derr.max().item(), ms=km, plain_ms=pm,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         shape=shape)
    del logits, d, want_d, derr

    res["adamw"] = adamw_at((1_000_003, 124_439_808), gen, "kernels-train",
                            weight_decay=0.1)
    res["adamw"]["shape"] += ", fp32 grads"
    return res


def _counters():
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    from vitrs_tpu_torch.ops import fused_gelu as GL
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    return {"flash_fwd": FA.flash_fwd_cuda, "flash_bwd": FA.flash_bwd_cuda,
            "flash_gqa_fwd": FG.flash_gqa_fwd_cuda,
            "flash_gqa_bwd": FG.flash_gqa_bwd_cuda,
            "flash_prefill": FP.flash_prefill_cuda,
            "ce_fwd": CE.ce_fwd_cuda, "ce_bwd": CE.ce_bwd_cuda,
            "adamw": FW.adamw_cuda, "head_ce_fwd": FH.head_ce_fwd_cuda,
            "gelu_fwd": GL.gelu_fwd_cuda, "gelu_bwd": GL.gelu_bwd_cuda}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def designed(**counts):
    """Every kernel's launch count: the given ones, 0 for the rest."""
    want = dict.fromkeys(_counters(), 0)
    want.update(counts)
    return want


def phase_train(smi, steps=12, kv_heads=0, overrides=None, B=8, tag=None,
                n_params=None, head_ce=False, optimizer="adamw", lr=6e-4,
                preset="gpt2-124m"):
    """GPT-2 124M (or `preset`), full width and depth, through train/loop.train; with
    kv_heads, its GQA variant through K3; `overrides` are the TrainConfig's
    model_overrides (the long-context rope + window model); head_ce sets
    ops/fused_head_ce.ENABLE, so the loss runs through K8 (and K6) instead
    of K5/K6; optimizer "muon" (lr the matrix lr, AdamW's 6e-4 for the
    rest) takes the tree-form step, which launches no K7."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    from vitrs_tpu_torch.train import loop
    tag = tag or ("[train-gqa]" if kv_heads else "[train]")
    overrides = dict(overrides or {})
    cfg = get_config(preset, num_kv_heads=kv_heads, **overrides)
    n_params = n_params or (114_990_336 if kv_heads == 4 else 124_439_808)
    check(P.num_parameters(cfg) == n_params, f"{tag} parameter count")
    T = cfg.max_seq_len
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset=preset, dataset="", steps=steps,
                              batch_size=B, warmup=2, min_lr=lr / 10,
                              weight_decay=0.1, dtype="bfloat16", log_every=1,
                              ckpt_every=0, workdir=work,
                              kv_heads=kv_heads, device="cuda",
                              optimizer=optimizer, lr=lr,
                              model_overrides=overrides or None)
        torch.cuda.reset_peak_memory_stats()
        FH.ENABLE = head_ce
        reset_counts()
        t0 = time.perf_counter()
        try:
            summary = loop.train(tc)
            torch.cuda.synchronize()
        finally:
            FH.ENABLE = False
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    L = cfg.num_layers
    fwd, bwd = (("flash_gqa_fwd", "flash_gqa_bwd") if kv_heads
                else ("flash_fwd", "flash_bwd"))
    loss_kernel = {"head_ce_fwd": steps} if head_ce else {"ce_fwd": steps}
    want = designed(**{fwd: L * steps, bwd: L * steps}, ce_bwd=steps,
                    adamw=steps if optimizer == "adamw" else 0,
                    gelu_fwd=L * steps, gelu_bwd=L * steps, **loss_kernel)
    check(counts == want, f"{tag} launches {counts} != designed {want}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{tag} losses {losses}")
    check(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    steady = recs[2:]                     # steps 1-2: warm-up (cuBLAS, allocator)
    tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
    mfu = float(np.median([r["mfu"] for r in steady]))
    step_ms = B * T / tok_s * 1e3
    what = ", ".join(f"{k}={v}" for k, v in overrides.items())
    print(f"{tag} {preset} kv_heads={cfg.kv_heads} {what} ({n_params} "
          f"params) bf16/fp32-master B={B} T={T} {steps} steps: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"{tag} losses {losses}")
    print(f"{tag} {optimizer}: launches per step: {fwd} "
          f"{counts[fwd] // steps}, {bwd} {counts[bwd] // steps} (3 kernels "
          f"each), {'head_ce_fwd' if head_ce else 'ce_fwd'}/ce_bwd"
          f"{'/adamw' if optimizer == 'adamw' else ''} 1, gelu_fwd "
          f"{counts['gelu_fwd'] // steps}, gelu_bwd "
          f"{counts['gelu_bwd'] // steps}, every other kernel 0")
    print(f"{tag} steady (steps 3-{steps}, median): {step_ms:.2f} ms/step, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} of 989 TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} s "
          f"incl. init and final checkpoint  ({smi})")
    print(f"{tag} per-step tok/s {[r['tok_per_sec'] for r in recs]}")
    return counts, dict(step_ms=step_ms, tok_s=tok_s, mfu=mfu,
                        peak_gib=peak / 2**30, final_loss=summary["final_loss"],
                        losses=losses)


def phase_xdevice_train(cfg=None, tag="xdevice-train"):
    """One training step of a small fp32 model (D=64: flash route; vocab
    16500 over 128 rows: fused CE route) on CUDA with the kernels and on the
    CPU with the plain versions, from the same weights and tokens.
    Tolerances (TF32 off, fp32 sums in other orders): loss rtol 1e-5; grads
    rtol 1e-4 + atol 1e-6, qkvb atol 2e-4 (its K third's gradient is exactly
    0, so both hold fp32 noise); params after the AdamW step rtol 2e-5 +
    atol 1e-6, or atol lr where |grad| < 1e-6 (AdamW from zero state moves
    such a value by lr g / (|g| + eps), which magnifies noise)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp
    if cfg is None:
        cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                             channels=128, max_seq_len=64,
                                             vocab_size=16500)
    params = P.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.vocab_size, (2, 64))
    y = rng.integers(0, cfg.vocab_size, (2, 64))
    lr = 1e-3
    out = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        loss = M.loss_fn(leaves, torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev), cfg)
        loss.backward()
        flat = P.flatten_params(params, cfg).to(dev)
        mesh = dp.make_mesh(devices=[dev])
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        step = dp.make_dp_train_step(cfg, mesh, clip_norm=1.0)
        new, _, _, step_loss = step(P.unflatten_params(flat, cfg), m, v, x, y,
                                     1, lr, 0.1)
        # a tensor the loss does not read (wpe under rope) has no gradient
        out[dev] = (loss.item(), {k: torch.zeros(t.shape) if t.grad is None
                                  else t.grad.cpu() for k, t in leaves.items()},
                    {k: t.detach().cpu() for k, t in new.items()},
                    step_loss.item(), read_counts())
    L = cfg.num_layers
    fwd, bwd = (("flash_gqa_fwd", "flash_gqa_bwd") if cfg.is_gqa
                else ("flash_fwd", "flash_bwd"))
    want = designed(**{fwd: 2 * L, bwd: 2 * L}, ce_fwd=2, ce_bwd=2, adamw=1,
                    gelu_fwd=2 * L, gelu_bwd=2 * L)
    check(out["cuda"][4] == want, f"{tag}: CUDA launches {out['cuda'][4]}")
    check(not any(out["cpu"][4].values()), f"{tag}: a kernel ran on CPU")
    lc, lp = out["cuda"][0], out["cpu"][0]
    gerr, perr = compare_steps(tag, out["cuda"], out["cpu"], lr)
    print(f"[{tag}] fp32 L=2 NH={cfg.num_heads} KH={cfg.kv_heads} "
          f"C={cfg.channels} V={cfg.vocab_size}: loss {lc:.6f} (cuda) vs "
          f"{lp:.6f} (cpu); 16 grads max_abs_err {gerr:.3e}; params after "
          f"one AdamW step max_abs_err {perr:.3e}")
    return out["cuda"][4]


def compare_steps(tag, got, want, lr):
    """Hold a training step on CUDA (got) against the CPU's (want), each
    (loss, grads, params after the step, step loss, launches), at phase
    xdevice-train's tolerances; returns the largest grad and param
    errors."""
    (lc, gc, pc, sc, _), (lp, gp, pp, sp, _) = got, want
    check(abs(lc - lp) <= 1e-5 * abs(lp) and abs(sc - sp) <= 1e-5 * abs(sp),
          f"{tag}: loss {lc} vs {lp}, step loss {sc} vs {sp}")
    gerr = perr = 0.0
    for k in gp:
        atol = 2e-4 if k == "qkvb" else 1e-6
        d = (gc[k] - gp[k]).abs()
        check(bool((d <= atol + 1e-4 * gp[k].abs()).all()),
              f"{tag}: grad {k} max err {d.max().item()}")
        gerr = max(gerr, d.max().item())
        tol = torch.where(gp[k].abs() < 1e-6, torch.full_like(gp[k], lr),
                          1e-6 + 2e-5 * pp[k].abs())
        d = (pc[k] - pp[k]).abs()
        check(bool((d <= tol).all()),
              f"{tag}: param {k} max err {d.max().item()}")
        perr = max(perr, d.max().item())
    return gerr, perr


def phase_kernels_gqa():
    """K3-fwd and K3-bwd against their plain versions at NH=12, KH in
    {4, 1} (R = 3 and MQA), T in {37, 512, 1000, 1024}, causal and full,
    then times at the GQA training shape (bf16 B=8 T=1024 KH=4 causal).
    Tolerances as K1/K2: out as `out_errors`, lse 1e-4 bf16 and 1e-5
    fp32; grads 2e-2 abs + rel bf16, 1e-4 fp32 (dk/dv sum up to 12 heads'
    fp32 terms in another order)."""
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    gen = torch.Generator(device="cuda").manual_seed(4)
    tols = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype, (lse_tol, bwd_tol) in tols.items():
        for KH in (4, 1):
            for T in (37, 512, 1000, 1024):
                for causal in (True, False):
                    qkv = torch.randn(4, T, C + 2 * KH * D, generator=gen,
                                      device="cuda").to(dtype)
                    do = torch.randn(4, T, C, generator=gen,
                                     device="cuda").to(dtype)
                    q, k, v = FG.split_gqa(qkv, NH, KH)
                    args = (NH, KH, causal, 0.125)
                    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, *args)
                    ref, ref_lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
                    got = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
                    want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
                    torch.cuda.synchronize()
                    where = f"K3 {dtype} KH={KH} T={T} causal={causal}"
                    check(torch.isfinite(out).all().item(),
                          f"{where}: out non-finite")
                    bad, err, rms = out_errors(out, ref)
                    check(bad == 0, f"{where}: {bad} out values beyond "
                          f"tolerance")
                    errs = [err]
                    for name, a, b in (("dq", got[0], want[0]),
                                       ("dk", got[1], want[1]),
                                       ("dv", got[2], want[2])):
                        check(torch.isfinite(a).all().item(),
                              f"{where}: {name} non-finite")
                        d = (a.float() - b.float()).abs()
                        bad = (d > bwd_tol + bwd_tol * b.float().abs()).sum().item()
                        check(bad == 0, f"{where}: {bad} {name} values beyond "
                              f"{bwd_tol}")
                        errs.append(d.max().item())
                    lse_err = (lse - ref_lse).abs().max().item()
                    check(lse_err <= lse_tol, f"{where}: lse err {lse_err}")
                    print(f"[kernels-gqa] {str(dtype)[6:]:8s} KH={KH} "
                          f"T={T:4d} causal={int(causal)} max_abs_err out "
                          f"{errs[0]:.3e} (rms {rms:.3e}) lse {lse_err:.3e} "
                          f"dq/dk/dv {errs[1]:.3e}/{errs[2]:.3e}/{errs[3]:.3e}")
                    if dtype == torch.bfloat16:
                        worst["fwd"] = max(worst["fwd"], errs[0])
                        worst["bwd"] = max(worst["bwd"], *errs[1:])
    worst["bwd"] = max(worst["bwd"], bwd_edge_cases("kernels-gqa", (4, 1), gen))
    KH = 4
    qkv = torch.randn(8, 1024, C + 2 * KH * D, generator=gen,
                      device="cuda").to(torch.bfloat16)
    do = torch.randn(8, 1024, C, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = FG.split_gqa(qkv, NH, KH)
    args = (NH, KH, True, 0.125)
    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, *args)
    res = {}
    shape = "bf16 B=8 T=1024 NH=12 KH=4 D=64 causal"
    for name, kernel, plain, lib, bnd in (
            ("flash_gqa_fwd", lambda: FG.flash_gqa_fwd_cuda(q, k, v, *args),
             lambda: FG.flash_gqa_fwd_plain(q, k, v, *args),
             lambda: sdpa(q, k, v, NH, KH),
             fwd_bound(8, NH, KH, D, 1024, 0, 1024, 2)[1]),
            ("flash_gqa_bwd",
             lambda: FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args),
             lambda: FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args),
             sdpa_bwd(q, k, v, do, NH, KH),
             bwd_bound(8, NH, KH, D, 1024, 2)[1])):
        km, pm, raw = timed_pair(kernel, plain)
        lib_ms = cuda_ms(lib)
        print(f"[kernels-gqa] {name} time {shape}: kernel {raw[0]:.4f}/"
              f"{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA "
              f"(enable_gqa) {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
        res[name] = dict(max_abs_err=worst[name[-3:]], ms=km, plain_ms=pm,
                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms,
                         shape=shape)
    flops = fwd_flops(8, 1024, 0, 1024)
    print_fwd_rate("kernels-gqa", "K3-fwd", res["flash_gqa_fwd"]["ms"], flops)
    res["flash_gqa_fwd"].update(tflops=flops / res["flash_gqa_fwd"]["ms"] / 1e9,
                                resources=fwd_resources())
    rsc, flops = bwd_resources(), bwd_flops(8, 1024)
    print_bwd_rate("kernels-gqa", "K3-bwd", res["flash_gqa_bwd"]["ms"], flops, rsc)
    res["flash_gqa_bwd"].update(tflops=flops / res["flash_gqa_bwd"]["ms"] / 1e9,
                                resources=rsc)
    return res


def phase_kernels_prefill():
    """K4 against its plain version: B=8, S=512, q_offset in {512, 3584,
    7168}, an 8K cache of 7936 slots (7808 rounded up to 256), KH in {4, 12},
    with every slot past the chunk's frontier NaN; tolerance as
    `out_errors` (in bf16 about 3e-4 + 2^-7 |out| at q_offset 7168, where
    |out| is about 0.02).  Then times at the last chunk of a 7680-token
    prompt (q_offset 7168, KH=4)."""
    from vitrs_tpu_torch.ops import flash_prefill as FP
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, Tk = 8, 512, 7936
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for KH in (4, 12):
            for q_off in (512, 3584, 7168):
                q = torch.randn(B, S, C, generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn(B, Tk, KH * D, generator=gen,
                                    device="cuda").to(dtype) for _ in range(2))
                k[:, q_off + S:] = float("nan")
                v[:, q_off + S:] = float("nan")
                got = FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125)
                want = FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125)
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(),
                      f"K4 KH={KH} q_off={q_off}: non-finite out")
                bad, err, rms = out_errors(got, want)
                check(bad == 0, f"K4 {dtype} KH={KH} q_off={q_off}: {bad} "
                      f"values beyond tolerance")
                print(f"[kernels-prefill] {str(dtype)[6:]:8s} KH={KH:2d} "
                      f"S={S} q_off={q_off} Tk={Tk} (NaN tail): max_abs_err "
                      f"{err:.3e} (rms {rms:.3e})")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                del q, k, v, got, want
    KH, q_off = 4, 7168
    q = torch.randn(B, S, C, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, Tk, KH * D, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    front = q_off + S
    mask = (torch.arange(front, device="cuda")[None, :]
            <= q_off + torch.arange(S, device="cuda")[:, None])
    km, pm, raw = timed_pair(
        lambda: FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125),
        lambda: FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125))
    lib = cuda_ms(lambda: sdpa(q, k[:, :front], v[:, :front], NH, KH, mask=mask))
    bms, by = fwd_bound(B, NH, KH, D, S, q_off, Tk, 2)[1]
    shape = "bf16 B=8 S=512 q_off=7168 Tk=7936 NH=12 KH=4 D=64"
    print(f"[kernels-prefill] time {shape}: kernel {raw[0]:.4f}/{raw[1]:.4f}"
          f" ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA (mask, enable_gqa)"
          f" {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    flops = fwd_flops(B, S, q_off, Tk)
    print_fwd_rate("kernels-prefill", "K4", km, flops)
    return dict(max_abs_err=worst, ms=km, plain_ms=pm, bound_ms=bms,
                bound_by=by, library_ms=lib, tflops=flops / km / 1e9,
                resources=fwd_resources(), shape=shape)


def _prefill_logits(G, pp, prompt, cfg, chunk, cache_len):
    """Last-position logits of a prefill in chunks of `chunk` tokens (0:
    the whole prompt), as models/generate.generate runs it."""
    caches = G.init_kv_cache(cfg, prompt.shape[0], cache_len, device="cuda")
    T0 = prompt.shape[1]
    step = chunk or T0
    for off in range(0, T0, step):
        logits, caches = G.forward_with_cache(pp, prompt[:, off:off + step],
                                              caches, off, cfg,
                                              last_only=True)
    return logits[:, -1].float()


def phase_serve_gqa(smi):
    """The JAX package's long-context GQA serving row
    (benchmarks/gen_variants.py --mode gqa --prefill-chunk 512): gpt2-124m
    with 4 kv heads at max_seq_len 8192, seeded random weights, bf16, B=8,
    a 7680-token seeded prompt, greedy; chunked (512) and whole-prompt
    prefill, each for 1 new token (prefill ms) and 128 (tok/s with the
    prefill, ms per new token).  Chunked and whole last-position logits:
    each bf16 run is held against the fp32 whole-prompt prefill of the same
    weights, and the two bf16 runs against each other (see the check)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt2-124m", num_kv_heads=4, max_seq_len=8192,
                     dtype="bfloat16")
    check(P.num_parameters(cfg) == 120_495_360, "gpt2-124m kv=4 8K params")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: t.to("cuda") for k, t in params.items()}
    pp = M.prepare_params(params, cfg)
    B, T0, L = 8, 7680, cfg.num_layers
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def run(chunk, max_new):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(pp, prompt, cfg, max_new, temperature=0.0,
                         prefill_chunk=chunk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(out.shape == (B, T0 + max_new), f"serve-gqa shape {out.shape}")
        gen = out[:, T0:]
        check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
              "serve-gqa ids")
        return ms, read_counts()

    run(512, 2)                                # warm-up: cuBLAS, allocator
    run(0, 2)
    res = {}
    for chunk in (512, 0):
        ms1, c1 = run(chunk, 1)
        msn, cn = run(chunk, 128)
        # GELU a layer a prefill chunk and a decode step
        chunks = T0 // chunk if chunk else 1
        want = designed(flash_gqa_fwd=L, flash_prefill=L * (chunks - 1),
                        gelu_fwd=L * chunks)
        wantn = dict(want, gelu_fwd=L * (chunks + 127))
        check(c1 == want and cn == wantn, f"serve-gqa chunk {chunk}: "
              f"launches {c1} / {cn} != {want} / {wantn}")
        per_tok = (msn - ms1) / 127
        res[chunk] = dict(prefill_ms=ms1, gen128_ms=msn,
                          tok_s=B * 128 / msn * 1e3, ms_per_new_token=per_tok,
                          launches=c1)
        print(f"[serve-gqa] chunk {chunk}: launches flash_gqa_fwd "
              f"{c1['flash_gqa_fwd']}, flash_prefill {c1['flash_prefill']}; "
              f"prefill (max_new=1) {ms1:.2f} ms; max_new=128 {msn:.2f} ms = "
              f"{B * 128 / msn * 1e3:.1f} tok/s incl. prefill, "
              f"{per_tok:.3f} ms per new token  ({smi})")
    chunked = _prefill_logits(G, pp, prompt, cfg, 512, 7936)
    whole = _prefill_logits(G, pp, prompt, cfg, 0, T0 + 1)
    cfg32 = cfg.replace(dtype="float32")
    ref = _prefill_logits(G, M.prepare_params(params, cfg32), prompt, cfg32,
                          0, T0 + 1)
    d_cw = (chunked - whole).abs().max().item()
    d_w = (whole - ref).abs().max().item()
    d_c = (chunked - ref).abs().max().item()
    check(all(torch.isfinite(t).all().item() for t in (chunked, whole, ref)),
          "serve-gqa: non-finite logits")
    # the last row's attention visits the same 64-key tiles in the same
    # order in K4 (chunk offsets are multiples of 64) as in K3-fwd, and the
    # other ops are row-wise, so on an H100 the two bf16 runs agree
    # bit for bit; 1e-3 (against logits up to about 2) leaves room for a
    # GEMM that picks another algorithm at another row count, and a wrong
    # chunk, mask or cache row moves logits by the bf16 run's own distance
    # from fp32 (about 3e-2) or more
    check(d_cw <= 1e-3, f"serve-gqa: chunked vs whole logits differ by "
          f"{d_cw}, bf16 vs fp32 by {d_w}")
    check(d_w <= 0.1, f"serve-gqa: bf16 vs fp32 logits differ by {d_w}")
    same = (chunked.argmax(-1) == whole.argmax(-1)).sum().item()
    print(f"[serve-gqa] last-position logits (max |logit| "
          f"{ref.abs().max().item():.3f}): chunked vs whole max_abs_err "
          f"{d_cw:.4e}; whole bf16 vs fp32 {d_w:.4e}; chunked bf16 vs fp32 "
          f"{d_c:.4e}; argmax equal in {same} of {B} rows")
    res["logits"] = dict(chunked_vs_whole=d_cw, whole_vs_fp32=d_w,
                         chunked_vs_fp32=d_c)
    del pp, params

    # MHA: K4 at KH = NH, the first chunk through K1-fwd
    mcfg = get_config("gpt2-124m", max_seq_len=4096, dtype="bfloat16")
    mp = M.prepare_params({k: t.to("cuda") for k, t in P.init_params(
        mcfg, torch.Generator().manual_seed(1)).items()}, mcfg)
    mprompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (4, 3584)), device="cuda")
    times = []
    for _ in range(2):                          # warm-up, then timed
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(mp, mprompt, mcfg, 1, temperature=0.0,
                         prefill_chunk=512)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    want = designed(flash_fwd=L, flash_prefill=L * 6, gelu_fwd=L * 7)
    check(counts == want, f"serve-mha chunked: launches {counts} != {want}")
    check(out.shape == (4, 3585), "serve-mha shape")
    print(f"[serve-gqa] MHA gpt2-124m B=4 3584-token prompt, chunk 512: "
          f"launches flash_fwd {counts['flash_fwd']}, flash_prefill "
          f"{counts['flash_prefill']}; prefill {times[1]:.2f} ms")
    res["mha_prefill_ms"] = times[1]
    return res


def phase_xdevice_gqa():
    """A small fp32 GQA model (L=2, NH=4, KH=2, C=256, D=64) on CUDA with
    the kernels and on the CPU with the plain versions: one training step
    (as xdevice-train), and a chunked generate (48-token prompt, chunk 16,
    8 new): the same greedy tokens, prefill logits within 1e-4, K3 and K4
    launched on CUDA only."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=4,
                                         num_kv_heads=2, channels=256,
                                         max_seq_len=64, vocab_size=16500)
    phase_xdevice_train(cfg, "xdevice-gqa")
    params = P.init_params(cfg, torch.Generator().manual_seed(6))
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 48)))
    toks, logits = {}, {}
    for dev in ("cuda", "cpu"):
        pp = M.prepare_params({k: t.to(dev) for k, t in params.items()}, cfg)
        reset_counts()
        toks[dev] = G.generate(pp, prompt.to(dev), cfg, 8, temperature=0.0,
                               prefill_chunk=16).cpu()
        counts = read_counts()
        want = (designed(flash_gqa_fwd=2, flash_prefill=4,
                         gelu_fwd=2 * (3 + 7)) if dev == "cuda"
                else designed())
        check(counts == want, f"xdevice-gqa generate on {dev}: {counts}")
        caches = G.init_kv_cache(cfg, 2, 256, device=dev)
        for off in range(0, 48, 16):
            chunk = prompt[:, off:off + 16].to(dev)
            lg, caches = G.forward_with_cache(pp, chunk, caches, off, cfg)
        logits[dev] = lg.cpu()
    check(torch.equal(toks["cuda"], toks["cpu"]),
          "xdevice-gqa: chunked generate tokens differ")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    check(err <= 1e-4, f"xdevice-gqa: chunked prefill logits differ by {err}")
    print(f"[xdevice-gqa] fp32 chunked generate: tokens equal on cuda and "
          f"cpu; last-chunk logits max_abs_err {err:.3e}")


# ---------------------------------------------------------------------------
# rope and the sliding window (K1-fwd, K2, K3, K4), and K8
# ---------------------------------------------------------------------------

EDGE_R2 = 12.0      # squared norm of each rotation pair of the band-edge q, k
EDGE_PAIRS = 12     # the rotation pairs they use: rope's 12 fastest


def band_edge_qk(B, S, Tk, nh, kh, window, q_off=0, rope=False,
                 device="cuda"):
    """q (B, S, nh*D) at positions q_off.. and k (B, Tk, kh*D) at 0.., fp32,
    whose scores peak at the lower edge of every query's band: pair i <
    EDGE_PAIRS of the rotated q and k gives EDGE_R2 cos(w_i (j - t - d0)),
    w_i rope's frequencies and d0 = 1/2 - window (the other pairs are 0),
    so the score of query t and key j is largest, and equal, at keys
    t - window + 1 (the band's last key) and t - window (the first key
    outside it), and at least 2 EDGE_R2 lower at every other key up to
    9000 away (3 after the 1/8 softmax scale; the peak is 17.6, so fp32
    scores keep most of their precision).  A band that ends one
    key early or late then moves the output by about |v|, where random
    inputs move it by about 1/window of its rms, below the bf16 bound
    (tests/test_torch_smoke_tolerance.py).  rope=True: q and k come
    unrotated (every row the same) for the kernels to rotate; else rotated
    at their positions."""
    from vitrs_tpu_torch.ops.rope import rope_table, rotate
    half = D // 2
    w = 10000.0 ** (-torch.arange(half, dtype=torch.float64) / half)
    d0 = 0.5 - window
    r = math.sqrt(EDGE_R2) * (torch.arange(half) < EDGE_PAIRS).double()
    a = torch.cat([r, torch.zeros(half, dtype=torch.float64)])
    b = torch.cat([r * torch.cos(w * d0), -r * torch.sin(w * d0)])
    q = a.float().repeat(nh).to(device).expand(B, S, -1)
    k = b.float().repeat(kh).to(device).expand(B, Tk, -1)
    if not rope:
        cos, sin = rope_table(max(q_off + S, Tk), D, device)
        q = rotate(q, cos[q_off:q_off + S], sin[q_off:q_off + S], nh)
        k = rotate(k, cos[:Tk], sin[:Tk], kh)
    return q.contiguous(), k.contiguous()


def band_mask(tq, q_off, keys, window, device="cuda"):
    """(tq, keys) bool, True where query row i sees key j: the explicit
    band PyTorch's SDPA takes."""
    rows = q_off + torch.arange(tq, device=device)[:, None]
    cols = torch.arange(keys, device=device)[None, :]
    return (cols <= rows) & (cols > rows - window)


def _attn_fns(kh):
    """(fwd kernel, fwd plain, bwd kernel, bwd plain) at kv width kh, each
    called as f(q, k, v, [out, lse, do,] causal, window, rope[, q_offset])
    (q_offset: the rectangle of the ring's cut hop)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    if kh == NH:
        return (lambda q, k, v, c, w, r, o=0: FA.flash_fwd_cuda(
                    q, k, v, NH, c, 0.125, w, r, o),
                lambda q, k, v, c, w, r, o=0: FA.flash_fwd_plain(
                    q, k, v, NH, c, 0.125, q_offset=o, window=w, rope=r),
                lambda q, k, v, o, l, d, c, w, r, off=0: FA.flash_bwd_cuda(
                    q, k, v, o, l, d, NH, c, 0.125, w, r, off),
                lambda q, k, v, o, l, d, c, w, r, off=0: FA.flash_bwd_plain(
                    q, k, v, o, l, d, NH, c, 0.125, window=w, rope=r,
                    q_offset=off))
    return (lambda q, k, v, c, w, r, o=0: FG.flash_gqa_fwd_cuda(
                q, k, v, NH, kh, c, 0.125, w, r, o),
            lambda q, k, v, c, w, r, o=0: FG.flash_gqa_fwd_plain(
                q, k, v, NH, kh, c, 0.125, w, r, o),
            lambda q, k, v, o, l, d, c, w, r, off=0: FG.flash_gqa_bwd_cuda(
                q, k, v, o, l, d, NH, kh, c, 0.125, w, r, off),
            lambda q, k, v, o, l, d, c, w, r, off=0: FG.flash_gqa_bwd_plain(
                q, k, v, o, l, d, NH, kh, c, 0.125, w, r, off))


def _check_band_fwd(where, W, out, lse, ref, ref_lse, v, kh, lse_tol):
    """Holds a forward with window W (out, lse) to its plain version (ref,
    ref_lse): out as `out_errors` and, at W=1, equal to v; lse relative to
    max(1, |lse|).  Returns (max_abs_err, rms, lse_err)."""
    check(torch.isfinite(out).all().item(), f"{where}: out non-finite")
    bad, err, rms = out_errors(out, ref)
    check(bad == 0, f"{where}: {bad} out values beyond tolerance "
          f"(max_abs_err {err:.3e})")
    if W == 1:        # p = 1 on the query's own key
        B, T = v.shape[:2]
        own = v.unflatten(-1, (kh, 1, D)).expand(
            B, T, kh, NH // kh, D).reshape(B, T, C)
        check(torch.equal(out, own), f"{where}: out != v at W=1")
    lse_err = ((lse - ref_lse).abs()
               / ref_lse.abs().clamp_min(1.0)).max().item()
    check(lse_err <= lse_tol, f"{where}: lse err {lse_err}")
    return err, rms, lse_err


def phase_kernels_rope_window():
    """K1-fwd and K2 (MHA), K3-fwd and K3-bwd (KH in {4, 1}) with rope and
    the band against their plain versions, bf16 and fp32, B=2, W in
    {1, 63, 64, 65, 1024}, T in {1000, 8192} with rope and T=1000 without
    it; then K1-fwd alone without rope at T=7680 (the serving prefill's
    band).  Inputs are the band-edge ones of `band_edge_qk`, except at
    T=1000, W=1024 (causal), where q and k are random.  At W=1 the output
    must equal v exactly.  Tolerances as K1-K3's: out as `out_errors`,
    grads 2e-2 abs + rel bf16 and 1e-4 fp32; lse 1e-4 bf16 and 1e-5 fp32,
    relative to max(1, |lse|) (the band-edge scores reach about 18).  Then
    K4 with W=1024 at q_offset 7168 (NaN tail) at B=8, KH=12 (the serving
    shape) and B=2, KH=4.  Times at T=8192, W=1024 with rope, and K4's at
    the serving shape, beside the band-aware bound (pairs = sum_t min(t +
    1, W) per (b, h)) and SDPA with an explicit band mask on q and k
    rotated beforehand; the windowed K2 must take under half the
    full-causal K2's time."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    from vitrs_tpu_torch.ops.rope import rope_qk
    gen = torch.Generator(device="cuda").manual_seed(8)
    tols = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}
    worst = {}
    B = 2
    n_cases = 0
    for dtype, (lse_tol, bwd_tol) in tols.items():
        for kh in (NH, 4, 1):
            fwd_k, fwd_p, bwd_k, bwd_p = _attn_fns(kh)
            for T, ropes in ((1000, (False, True)), (8192, (True,))):
                for rope in ropes:
                    for W in (1, 63, 64, 65, 1024):
                        if W < T:
                            q, k = band_edge_qk(B, T, T, NH, kh, W, rope=rope)
                        else:
                            q = torch.randn(B, T, C, generator=gen, device="cuda")
                            k = torch.randn(B, T, kh * D, generator=gen,
                                            device="cuda")
                        v = torch.randn(B, T, kh * D, generator=gen, device="cuda")
                        do = torch.randn(B, T, C, generator=gen, device="cuda")
                        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
                        where = (f"{str(dtype)[6:]} KH={kh} T={T} W={W} "
                                 f"rope={int(rope)}")
                        out, lse = fwd_k(q, k, v, True, W, rope)
                        ref, ref_lse = fwd_p(q, k, v, True, W, rope)
                        got = bwd_k(q, k, v, out, lse, do, True, W, rope)
                        want = bwd_p(q, k, v, out, lse, do, True, W, rope)
                        torch.cuda.synchronize()
                        err, rms, lse_err = _check_band_fwd(
                            where, W, out, lse, ref, ref_lse, v, kh, lse_tol)
                        errs = [err]
                        for name, a, b in zip(("dq", "dk", "dv"), got, want):
                            check(torch.isfinite(a).all().item(),
                                  f"{where}: {name} non-finite")
                            d = (a.float() - b.float()).abs()
                            nbad = (d > bwd_tol + bwd_tol * b.float().abs()
                                    ).sum().item()
                            check(nbad == 0, f"{where}: {nbad} {name} values "
                                  f"beyond {bwd_tol}")
                            errs.append(d.max().item())
                        n_cases += 1
                        print(f"[kernels-rope-window] {where}: max_abs_err out "
                              f"{errs[0]:.3e} (rms {rms:.3e}) lse(rel) "
                              f"{lse_err:.3e} dq/dk/dv {errs[1]:.3e}/"
                              f"{errs[2]:.3e}/{errs[3]:.3e}")
                        if dtype == torch.bfloat16:
                            key = "mha" if kh == NH else "gqa"
                            worst[key + "_fwd"] = max(worst.get(key + "_fwd", 0.0),
                                                      errs[0])
                            worst[key + "_bwd"] = max(worst.get(key + "_bwd", 0.0),
                                                      *errs[1:])
                        del q, k, v, do, out, lse, ref, ref_lse, got, want
    print(f"[kernels-rope-window] {n_cases} cases within tolerance")

    # the serving prefill's K1-fwd: the band with rope=False (generate
    # rotates q and k before the cache write) on a whole 7680-token prompt,
    # as serve-window runs it (there at B=8; B=2 keeps the plain version's
    # fp32 T x T scores small); forward only
    T = 7680
    fwd_k, fwd_p = _attn_fns(NH)[:2]
    for dtype, (lse_tol, _) in tols.items():
        for W in (1, 63, 64, 65, 1024):
            q, k = band_edge_qk(B, T, T, NH, NH, W)
            v = torch.randn(B, T, C, generator=gen, device="cuda")
            q, k, v = (t.to(dtype) for t in (q, k, v))
            where = f"{str(dtype)[6:]} KH={NH} T={T} W={W} rope=0 (fwd only)"
            out, lse = fwd_k(q, k, v, True, W, False)
            ref, ref_lse = fwd_p(q, k, v, True, W, False)
            torch.cuda.synchronize()
            err, rms, lse_err = _check_band_fwd(where, W, out, lse, ref,
                                                ref_lse, v, NH, lse_tol)
            print(f"[kernels-rope-window] {where}: max_abs_err out {err:.3e} "
                  f"(rms {rms:.3e}) lse(rel) {lse_err:.3e}")
            if dtype == torch.bfloat16:
                worst["mha_fwd"] = max(worst["mha_fwd"], err)
            del q, k, v, out, lse, ref, ref_lse

    # K4: a 512-query chunk at q_offset 7168 against an 8K cache, W=1024:
    # at the serving shape (B=8, the window model's 12 kv heads) and at
    # B=2, KH=4
    S, q_off, Tk, W = 512, 7168, 7936, 1024
    for dtype in (torch.bfloat16, torch.float32):
        for Bp, kh in ((8, NH), (B, 4)):
            q, k = band_edge_qk(Bp, S, Tk, NH, kh, W, q_off=q_off)
            v = torch.randn(Bp, Tk, kh * D, generator=gen, device="cuda")
            q, k, v = (t.to(dtype) for t in (q, k, v))
            k[:, q_off + S:] = float("nan")
            v[:, q_off + S:] = float("nan")
            got = FP.flash_prefill_cuda(q, k, v, NH, kh, q_off, 0.125, W)
            want = FP.flash_prefill_plain(q, k, v, NH, kh, q_off, 0.125, W)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(), "K4 window: non-finite")
            bad, err, rms = out_errors(got, want)
            check(bad == 0, f"K4 window {dtype} B={Bp} KH={kh}: {bad} values "
                  f"beyond tolerance")
            print(f"[kernels-rope-window] K4 {str(dtype)[6:]} B={Bp} KH={kh} "
                  f"S={S} q_off={q_off} W={W} (NaN tail): max_abs_err "
                  f"{err:.3e} (rms {rms:.3e})")
            del q, k, v, got, want
            if dtype == torch.bfloat16:
                worst["prefill"] = max(worst.get("prefill", 0.0), err)

    # times at the training shape: bf16 B=2 T=8192 W=1024 rope
    T = 8192
    res = {}
    for kh in (NH, 4):
        fwd_k, fwd_p, bwd_k, bwd_p = _attn_fns(kh)
        q, k, v, do = (torch.randn(B, T, n, generator=gen, device="cuda")
                       .bfloat16() for n in (C, kh * D, kh * D, C))
        out, lse = fwd_k(q, k, v, True, W, True)
        qr, kr = rope_qk(q, k, torch.arange(T, device="cuda"), NH, kh)
        mask = band_mask(T, 0, T, W)
        key = "mha" if kh == NH else "gqa"
        shape = f"bf16 B=2 T=8192 NH=12 KH={kh} D=64 W=1024 rope"
        for part, kern, plain, lib, bnd in (
                ("fwd", lambda: fwd_k(q, k, v, True, W, True),
                 lambda: fwd_p(q, k, v, True, W, True),
                 lambda: sdpa(qr, kr, v, NH, kh, mask=mask),
                 fwd_bound(B, NH, kh, D, T, 0, T, 2, window=W,
                           rope=True)[1]),
                ("bwd", lambda: bwd_k(q, k, v, out, lse, do, True, W, True),
                 lambda: bwd_p(q, k, v, out, lse, do, True, W, True),
                 sdpa_bwd(qr, kr, v, do, NH, kh, mask=mask),
                 bwd_bound(B, NH, kh, D, T, 2, window=W, rope=True)[1])):
            km, pm, raw = timed_pair(kern, plain, iters=5, warmup=1)
            lib_ms = cuda_ms(lib, iters=5, warmup=1)
            print(f"[kernels-rope-window] {key}_{part} time {shape}: kernel "
                  f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/"
                  f"{raw[3]:.4f} ms, SDPA (band mask) {lib_ms:.4f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})")
            res[f"{key}_{part}"] = dict(
                max_abs_err=worst[f"{key}_{part}"], ms=km, plain_ms=pm,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms,
                shape=shape)
            if part == "fwd":
                rsc, flops = fwd_resources(True, True), fwd_flops(B, T, 0, T, window=W)
                print_fwd_rate("kernels-rope-window", f"{key}_fwd", km, flops, rsc)
                res[f"{key}_fwd"].update(tflops=flops / km / 1e9, resources=rsc)
            if part == "bwd":
                rsc, flops = bwd_resources(True), bwd_flops(B, T, W)
                print_bwd_rate("kernels-rope-window", f"{key}_bwd", km, flops, rsc)
                res[f"{key}_bwd"].update(tflops=flops / km / 1e9, resources=rsc)
        if kh == NH:
            # the band must skip tiles: the full-causal K2 at the same shape
            out_c, lse_c = fwd_k(q, k, v, True, 0, True)
            full = cuda_ms(lambda: bwd_k(q, k, v, out_c, lse_c, do, True, 0,
                                         True), iters=5, warmup=1)
            win = cuda_ms(lambda: bwd_k(q, k, v, out, lse, do, True, W, True),
                          iters=5, warmup=1)
            print(f"[kernels-rope-window] K2 T=8192 rope: W=1024 {win:.4f} ms, "
                  f"full causal {full:.4f} ms (ratio {win / full:.3f}, "
                  f"{bwd_flops(B, T) / full / 1e9:.1f} TFLOP/s)")
            check(win < 0.5 * full, f"windowed K2 {win} ms is not under half "
                  f"the full-causal {full} ms: the band skips nothing")
            res["mha_bwd"]["full_causal_ms"] = full
            res["mha_bwd"]["full_causal_bound_ms"] = bwd_bound(
                B, NH, kh, D, T, 2, rope=True)[1][0]
        del q, k, v, do, out, lse, qr, kr, mask
    # K4 at the serving shape: B=8, the window model's 12 kv heads
    Bp, kh = 8, NH
    q, k = band_edge_qk(Bp, S, Tk, NH, kh, W, q_off=q_off)
    v = torch.randn(Bp, Tk, kh * D, generator=gen, device="cuda")
    q, k, v = (t.bfloat16() for t in (q, k, v))
    front = q_off + S
    mask = band_mask(S, q_off, front, W)
    km, pm, raw = timed_pair(
        lambda: FP.flash_prefill_cuda(q, k, v, NH, kh, q_off, 0.125, W),
        lambda: FP.flash_prefill_plain(q, k, v, NH, kh, q_off, 0.125, W))
    lib = cuda_ms(lambda: sdpa(q, k[:, :front], v[:, :front], NH, kh, mask=mask))
    bms, by = fwd_bound(Bp, NH, kh, D, S, q_off, Tk, 2, window=W)[1]
    shape = "bf16 B=8 S=512 q_off=7168 Tk=7936 NH=12 KH=12 D=64 W=1024"
    print(f"[kernels-rope-window] K4 time {shape}: kernel {raw[0]:.4f}/"
          f"{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA (band "
          f"mask) {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    flops = fwd_flops(Bp, S, q_off, Tk, window=W)
    rsc = fwd_resources(False, True)
    print_fwd_rate("kernels-rope-window", "K4 band", km, flops, rsc)
    res["prefill"] = dict(max_abs_err=worst["prefill"], ms=km, plain_ms=pm,
                          bound_ms=bms, bound_by=by, library_ms=lib,
                          tflops=flops / km / 1e9, resources=rsc, shape=shape)
    del q, k, v, mask

    # K1-fwd with the band and no rope at the serve-window whole-prompt
    # shape (B=8, T=7680): kernel and SDPA with a band mask; the plain
    # version's fp32 (8, 12, T, T) scores (22.6 GB a tensor) are not timed
    # here (its B=2 check above)
    T = 7680
    q, k = band_edge_qk(8, T, T, NH, NH, W)
    v = torch.randn(8, T, C, generator=gen, device="cuda")
    q, k, v = (t.bfloat16() for t in (q, k, v))
    mask = band_mask(T, 0, T, W)
    ks = [cuda_ms(lambda: FA.flash_fwd_cuda(q, k, v, NH, True, 0.125, W),
                  iters=5, warmup=1) for _ in range(2)]
    lib = cuda_ms(lambda: sdpa(q, k, v, NH, NH, mask=mask), iters=5, warmup=1)
    bms, by = fwd_bound(8, NH, NH, D, T, 0, T, 2, window=W)[1]
    flops = fwd_flops(8, T, 0, T, window=W)
    km = sum(ks) / 2
    shape = "bf16 B=8 T=7680 NH=12 D=64 W=1024"
    print(f"[kernels-rope-window] K1-fwd band time {shape}: kernel "
          f"{ks[0]:.4f}/{ks[1]:.4f} ms, SDPA (band mask) {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    print_fwd_rate("kernels-rope-window", "K1-fwd band T=7680", km, flops)
    res["mha_fwd"]["serve_band"] = dict(ms=km, plain_ms=None, bound_ms=bms,
                                        bound_by=by, library_ms=lib,
                                        tflops=flops / km / 1e9, shape=shape)
    return res


def headce_resources():
    """{kernel: registers per thread, spill bytes, shared memory per block,
    threads (and the tile kernel's persistent grid)} of the bf16 K8
    kernels as built (the tile kernel and the merge; csrc/fused_head_ce.cu's
    vitrs_head_ce_attrs); fails on a spill."""
    import ctypes
    from vitrs_tpu_torch.ops import _build
    fn = _build.load("fused_head_ce").lib.vitrs_head_ce_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    res = {}
    for i, name in enumerate(("tile", "merge")):
        out = (ctypes.c_int * 6)()
        rc = fn(i, ctypes.cast(out, ctypes.c_void_p))
        check(rc == 0, f"vitrs_head_ce_attrs({name}): CUDA error {rc}")
        res[name] = dict(registers=out[0], spill_bytes=out[1],
                         smem_bytes=out[2] + out[3], threads=out[4])
        if i == 0:
            res[name]["grid_blocks"] = out[5]
        check(out[1] == 0, f"K8 {name} spills {out[1]} bytes a thread")
    return res


def headce_errors(tag, got, want, targets, V):
    """Errors of a K8 result (logits, lse, picked) against the plain
    version's, raising beyond the tolerances of `phase_kernels_headce`.
    Rows whose target lies outside [0, V) must pick NaN; the others are
    held to the plain pick.  Returns the largest error."""
    (logits, lse, picked), (rl, rlse, rpick) = got, want
    dl = (logits.float() - rl.float()).abs()
    over = dl - (2.0 ** -7 * rl.float().abs() + 1e-5)
    bad = (over > 0).sum().item()
    i = int(over.argmax())
    worst_pair = (logits.flatten()[i].item(), rl.flatten()[i].item())
    real = (targets >= 0) & (targets < V)
    lse_err = (lse - rlse).abs().max().item()
    pick_err = (picked[real] - rpick[real]).abs().max().item() if real.any() else 0.0
    check(torch.isfinite(logits).all().item() and torch.isfinite(lse).all().item(),
          f"K8 {tag}: non-finite logits or lse")
    check(bad == 0, f"K8 {tag}: {bad} logits beyond one bf16 ulp + 1e-5 "
          f"(worst got/want {worst_pair})")
    check(lse_err <= 1e-4 and pick_err <= 1e-5,
          f"K8 {tag}: lse err {lse_err}, picked err {pick_err}")
    check(bool(picked[~real].isnan().all()), f"K8 {tag}: a target outside "
          f"[0, {V}) did not pick NaN")
    return max(dl.max().item(), lse_err, pick_err)


def headce_edge_cases(gen):
    """K8 bf16 against its plain version around its tiles (64 rows x 256
    vocab columns, 64-wide k steps): R in {1, 127, 129, 8191}, C in {64, 96,
    768, 1600} (96: a half k step; 1600: gpt2-1558m), Vp in {128, 1152,
    50304} (each leaves a ragged last vocab tile), a strided x and w
    that TMA maps in place; targets on the last real column, in the pad
    columns and out of range (NaN picks); each case twice, bitwise equal.
    Then views TMA refuses (a base or row stride off 16 bytes, rows
    broadcast) must raise ValueError before any launch.  Returns the
    largest error."""
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    worst = 0.0
    cases = [(1, 768, 50304, 50257), (127, 768, 50304, 50257),
             (129, 768, 50304, 50257), (8191, 768, 50304, 50257),
             (256, 64, 1152, 1100), (129, 96, 1152, 1100),
             (300, 1600, 50304, 50257), (200, 768, 128, 100),
             (1000, 768, 1152, 1100)]
    for R, Cx, Vp, V in cases:
        strided = R == 1000      # x and w as column slices of wider rows
        xb = torch.randn(R, Cx + 64 * strided, generator=gen, device="cuda")
        wb = 0.02 * torch.randn(Vp, Cx + 64 * strided, generator=gen,
                                device="cuda")
        x, w = xb.bfloat16()[:, :Cx], wb.bfloat16()[:, :Cx]
        w[V:] = 0
        t = torch.randint(0, V, (R,), generator=gen, device="cuda")
        special = [V - 1, V, Vp + 5, -1][:R]      # every case has V < Vp
        t[:len(special)] = torch.tensor(special, device="cuda")
        before = FH.head_ce_fwd_cuda.launches
        got = FH.head_ce_fwd_cuda(x, w, t, V)
        again = FH.head_ce_fwd_cuda(x, w, t, V)
        want = FH.head_ce_fwd_plain(x, w, t.clamp(0, Vp - 1), V)
        torch.cuda.synchronize()
        check(FH.head_ce_fwd_cuda.launches == before + 2, "K8 launch count")
        tag = f"R={R} C={Cx} Vp={Vp} V={V}" + (" strided" if strided else "")
        err = headce_errors(tag, got, want, t, V)
        same = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                               else a.view(torch.int32),
                               b.view(torch.int16) if b.dtype == torch.bfloat16
                               else b.view(torch.int32))
                   for a, b in zip(got, again))
        check(same, f"K8 {tag}: two calls differ")
        print(f"[kernels-headce] edge {tag}: max err {err:.3e}, targets "
              f"{special} (NaN outside [0, {V})), two calls bitwise equal")
        worst = max(worst, err)
    R, Cx, Vp, V = 64, 768, 1024, 1000
    buf = torch.randn(R * Cx + 8, generator=gen, device="cuda").bfloat16()
    w = torch.randn(Vp, Cx, generator=gen, device="cuda").bfloat16()
    x = buf[:R * Cx].view(R, Cx)
    t = torch.randint(0, V, (R,), generator=gen, device="cuda")
    refused = {"x base off 16 bytes": (buf[1:1 + R * Cx].view(R, Cx), w),
               "x row stride off 16 bytes":
                   (torch.randn(R, Cx + 1, generator=gen, device="cuda")
                    .bfloat16()[:, :Cx], w),
               "w rows broadcast": (x, w[:1].expand(Vp, Cx))}
    for what, (xv, wv) in refused.items():
        before = FH.head_ce_fwd_cuda.launches
        try:
            FH.head_ce_fwd_cuda(xv, wv, t, V)
            raised = False
        except ValueError:
            raised = True
        check(raised and FH.head_ce_fwd_cuda.launches == before,
              f"K8 took a view TMA cannot map: {what}")
    print(f"[kernels-headce] refused before any launch: {sorted(refused)}")
    return worst


def phase_kernels_headce():
    """K8 against its plain version at R in {8192, 16384}, C=768, Vp=50304
    (real vocab 50257, zero pad rows), bf16, and at `headce_edge_cases`:
    logits within one bf16 ulp plus the picked bound (2^-7 |want| + 1e-5:
    each side rounds an fp32 sum of C products, summed in another order, so
    near 0, where the ulp is smaller than that sum's error, the two
    roundings can differ by more than one ulp), lse 1e-4 (K5's: an fp32
    logsumexp over 50257 columns in another order), picked 1e-5 (one fp32
    dot, |picked| about 0.6).  Times beside the bound (2 R C Vp operations
    on the tensor cores: 0.640 and 1.280 ms), the bare product
    torch.matmul(x, w.t()), torch.matmul + F.cross_entropy on the bf16
    logits (two calls: no one PyTorch call computes the same function) and
    the port's two-op route that K8 replaces (cuBLAS, then K5); K8's
    TFLOP/s and resources.  Then the loss and both gradients through
    `head_ce_mean` (K8, K6 and two matmuls) against the two-op route
    (matmul, K5, K6) at R=8192: loss rtol 1e-4 (K8's lse reads the fp32
    product, K5's the bf16 logits), grads within 1e-2 of their largest
    value."""
    import torch.nn.functional as F
    from vitrs_tpu_torch.ops import basic
    from vitrs_tpu_torch.ops import fused_ce as CE
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    gen = torch.Generator(device="cuda").manual_seed(9)
    V, Vp = 50257, 50304
    res = {}
    worst = headce_edge_cases(gen)
    rsc = headce_resources()
    for R in (8192, 16384):
        x = torch.randn(R, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(Vp, C, generator=gen, device="cuda")).bfloat16()
        w[V:] = 0
        t = torch.randint(0, V, (R,), generator=gen, device="cuda")
        got = FH.head_ce_fwd_cuda(x, w, t, V)
        want = FH.head_ce_fwd_plain(x, w, t, V)
        torch.cuda.synchronize()
        err = headce_errors(f"R={R}", got, want, t, V)
        worst = max(worst, err)
        del got, want
        km, pm, raw = timed_pair(lambda: FH.head_ce_fwd_cuda(x, w, t, V),
                                 lambda: FH.head_ce_fwd_plain(x, w, t, V),
                                 iters=10, warmup=2)
        # the yardsticks: the bare padded product (an aligned N for cuBLAS;
        # the 50257 real rows alone take an odd N and a slower GEMM); that
        # product, then F.cross_entropy on the real columns of the bf16
        # logits, no cast; the port's own route that K8 replaces: cuBLAS,
        # then K5
        mm = cuda_ms(lambda: torch.matmul(x, w.t()), iters=10, warmup=2)
        lib = cuda_ms(lambda: F.cross_entropy(
            torch.matmul(x, w.t())[:, :V], t, reduction="none"),
            iters=10, warmup=2)
        two_op = cuda_ms(lambda: CE.ce_fwd_cuda(basic.linear(x, w), t, V),
                         iters=10, warmup=2)
        # reads x, w and the targets, writes the bf16 logits, lse, picked
        flops = 2 * R * C * Vp
        bms, by = bound(flops, "bf16",
                        2 * R * C + 2 * Vp * C + 8 * R + 2 * R * Vp + 8 * R)
        shape = f"bf16 R={R} C=768 Vp={Vp} real_vocab={V}"
        print(f"[kernels-headce] K8 {shape}: max err {err:.3e}; kernel "
              f"{raw[0]:.4f}/{raw[1]:.4f} ms ({flops / km / 1e9:.1f} "
              f"TFLOP/s), plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
              f"torch.matmul {mm:.4f} ms ({flops / mm / 1e9:.1f} TFLOP/s), "
              f"torch.matmul + F.cross_entropy (bf16) {lib:.4f} ms, cuBLAS "
              f"+ K5 {two_op:.4f} ms, bound {bms:.4f} ms ({by})")
        res[R] = dict(ms=km, plain_ms=pm, bound_ms=bms, bound_by=by,
                      library_ms=lib, two_op_ms=two_op, matmul_ms=mm,
                      tflops=flops / km / 1e9, shape=shape)
        del x, w, t
    res[8192]["max_abs_err"] = worst
    res[8192]["resources"] = rsc
    print("[kernels-headce] K8 " + "; ".join(
        f"{k} {v['registers']} registers, {v['spill_bytes']} B spilled, "
        f"{v['smem_bytes']} B shared, {v['threads']} threads"
        + (f", persistent grid {v['grid_blocks']} blocks" if "grid_blocks" in v
           else "")
        for k, v in rsc.items()))

    R = 8192
    x = torch.randn(R, C, generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn(Vp, C, generator=gen, device="cuda")).bfloat16()
    w[V:] = 0
    t = torch.randint(0, V, (R,), generator=gen, device="cuda")
    out = {}
    for route in ("k8", "two-op"):
        xl, wl = (a.detach().clone().requires_grad_(True) for a in (x, w))
        if route == "k8":
            loss = FH.head_ce_mean(xl, wl, t, V)
        else:
            loss = CE.cross_entropy_mean(basic.linear(xl, wl), t, real_vocab=V)
        loss.backward()
        out[route] = (loss.item(), xl.grad.float(), wl.grad.float())
    (l8, dx8, dw8), (l2, dx2, dw2) = out["k8"], out["two-op"]
    ex = ((dx8 - dx2).abs().max() / dx2.abs().max()).item()
    ew = ((dw8 - dw2).abs().max() / dw2.abs().max()).item()
    print(f"[kernels-headce] autograd R={R}: loss {l8:.6f} (K8) vs {l2:.6f} "
          f"(two-op); dX, dW max err {ex:.3e}, {ew:.3e} of their largest; "
          f"dW pad rows {dw8[V:].abs().max().item():.1e}")
    check(abs(l8 - l2) <= 1e-4 * abs(l2), f"K8 loss {l8} vs two-op {l2}")
    check(ex <= 1e-2 and ew <= 1e-2, f"K8 grads differ: {ex}, {ew}")
    check(bool((dw8[V:] == 0).all()), "K8: dW pad rows not 0")
    return res


def phase_serve_window(smi):
    """The JAX package's streaming-window serving row (benchmarks/
    gen_variants.py --mode window): gpt2-124m at max_seq_len 8192 with
    window 1024 and rope (129,944,832 parameters), seeded random weights,
    bf16, B=8, a 7680-token seeded prompt, greedy.  `generate` whole (K1-fwd
    with the band, q and k rotated before the cache write) and in 512-token
    chunks (then K4 with the band): launches, prefill ms, and the chunked
    and whole last-position logits within 1e-3 (they read the same 64-key
    tiles in the same order).  Then `generate_streaming` (the ring cache,
    plain torch) for 32 new tokens: ms per new token, and the first token
    where it departs from the dense-cache `generate` (bf16 near-ties: the
    ring attends in another order)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt2-124m", max_seq_len=8192, window=1024,
                     pos_emb="rope", dtype="bfloat16")
    check(P.num_parameters(cfg) == 129_944_832, "rope + window 8K params")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    pp = M.prepare_params({k: t.to("cuda") for k, t in params.items()}, cfg)
    del params
    B, T0, L = 8, 7680, cfg.num_layers
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, read_counts()

    res = {}
    for chunk in (512, 0):
        gen = lambda n: G.generate(pp, prompt, cfg, n, temperature=0.0,
                                   prefill_chunk=chunk)
        timed(lambda: gen(2))                  # warm-up: cuBLAS, allocator
        _, ms1, counts = timed(lambda: gen(1))
        chunks = T0 // chunk if chunk else 1
        want = designed(flash_fwd=L, flash_prefill=L * (chunks - 1),
                        gelu_fwd=L * chunks)
        check(counts == want, f"serve-window chunk {chunk}: launches "
              f"{counts} != {want}")
        res[chunk] = dict(prefill_ms=ms1, launches=counts)
        print(f"[serve-window] chunk {chunk}: launches flash_fwd "
              f"{counts['flash_fwd']}, flash_prefill {counts['flash_prefill']}"
              f"; prefill (max_new=1) {ms1:.2f} ms  ({smi})")
    chunked = _prefill_logits(G, pp, prompt, cfg, 512, 7936)
    whole = _prefill_logits(G, pp, prompt, cfg, 0, T0 + 1)
    d_cw = (chunked - whole).abs().max().item()
    check(torch.isfinite(whole).all().item(), "serve-window: non-finite")
    print(f"[serve-window] last-position logits chunked vs whole max_abs_err "
          f"{d_cw:.4e} (max |logit| {whole.abs().max().item():.3f})")
    check(d_cw <= 1e-3, f"serve-window: chunked vs whole logits differ by "
          f"{d_cw}")
    res["chunked_vs_whole"] = d_cw

    n = 32
    dense, dense_ms, _ = timed(lambda: G.generate(pp, prompt, cfg, n,
                                                  temperature=0.0))
    G.generate_streaming(pp, prompt, cfg, 2, temperature=0.0)   # warm-up
    _, s1, c1 = timed(lambda: G.generate_streaming(pp, prompt, cfg, 1,
                                                   temperature=0.0))
    ring, sn, cn = timed(lambda: G.generate_streaming(pp, prompt, cfg, n,
                                                      temperature=0.0))
    # the ring path runs no flash kernel; GELU a layer a ring chunk of the
    # prompt and a decode step
    chunks = -(-T0 // cfg.window)
    check(c1 == designed(gelu_fwd=L * chunks)
          and cn == designed(gelu_fwd=L * (chunks + n - 1)),
          f"serve-window: the ring path's launches {c1} / {cn}")
    check(ring.shape == (B, T0 + n) and bool(
        ((ring[:, T0:] >= 0) & (ring[:, T0:] < cfg.vocab_size)).all()),
        "serve-window: streaming output")
    diff = (ring[:, T0:] != dense[:, T0:]).int()
    first = [int(r.argmax()) if r.any() else None for r in diff.cpu()]
    per_tok = (sn - s1) / (n - 1)
    print(f"[serve-window] generate_streaming B={B} {n} new: prefill "
          f"(max_new=1) {s1:.2f} ms, {sn:.2f} ms in all, {per_tok:.3f} ms per "
          f"new token; dense-cache generate {dense_ms:.2f} ms; first new token "
          f"where ring and dense differ, per row: {first}")
    res.update(stream_ms_per_token=per_tok, stream_prefill_ms=s1,
               dense_gen_ms=dense_ms, first_divergence=first)
    return res


def phase_xdevice_window():
    """Small fp32 models with rope and window 8 (L=2, NH=2, C=128, D=64,
    vocab 16500), kv in {2 (MHA), 1}: one training step (as xdevice-train:
    K1/K2 or K3, K5, K6, K7 on CUDA) and a chunked generate (48-token
    prompt, chunk 16, 8 new: K1-fwd or K3-fwd, then K4, each with the band)
    on CUDA against the CPU's plain versions: the same greedy tokens,
    last-chunk logits within 1e-4."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    counts = {}
    for kv in (2, 1):
        cfg = get_config("gpt-nano").replace(
            num_layers=2, num_heads=2, num_kv_heads=kv, channels=128,
            max_seq_len=64, vocab_size=16500, pos_emb="rope", window=8)
        train = phase_xdevice_train(cfg, f"xdevice-window kv={kv}")
        params = P.init_params(cfg, torch.Generator().manual_seed(10))
        prompt = torch.as_tensor(np.random.default_rng(10).integers(
            0, cfg.vocab_size, (2, 48)))
        fwd = "flash_gqa_fwd" if cfg.is_gqa else "flash_fwd"
        toks, logits = {}, {}
        for dev in ("cuda", "cpu"):
            pp = M.prepare_params({k: t.to(dev) for k, t in params.items()},
                                  cfg)
            reset_counts()
            toks[dev] = G.generate(pp, prompt.to(dev), cfg, 8,
                                   temperature=0.0, prefill_chunk=16).cpu()
            got = read_counts()
            want = (designed(**{fwd: 2, "flash_prefill": 4},
                             gelu_fwd=2 * (3 + 7)) if dev == "cuda"
                    else designed())
            check(got == want, f"xdevice-window generate on {dev}: {got}")
            caches = G.init_kv_cache(cfg, 2, 256, device=dev)
            for off in range(0, 48, 16):
                lg, caches = G.forward_with_cache(
                    pp, prompt[:, off:off + 16].to(dev), caches, off, cfg)
            logits[dev] = lg.cpu()
        check(torch.equal(toks["cuda"], toks["cpu"]),
              f"xdevice-window kv={kv}: generate tokens differ")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(err <= 1e-4, f"xdevice-window kv={kv}: logits differ by {err}")
        print(f"[xdevice-window] kv={kv} fp32 rope W=8 chunked generate: "
              f"tokens equal on cuda and cpu; last-chunk logits max_abs_err "
              f"{err:.3e}")
        counts[kv] = train
    return counts


WINDOW = {"max_seq_len": 8192, "window": 1024, "pos_emb": "rope"}
WINDOW_PARAMS = 129_944_832      # 124,439,808 + 7,168 extra wpe rows x 768


def phase_train_window(smi):
    """The long-context path: GPT-2 124M at T=8192, W=1024, rope, B=2, 12
    steps (K1-fwd and K2 with the in-kernel rotation and the band), then
    the full-causal control (W=0, rope) in the same call."""
    counts, res = phase_train(smi, overrides=WINDOW, B=2, tag="[train-window]",
                              n_params=WINDOW_PARAMS)
    _, full = phase_train(smi, overrides=dict(WINDOW, window=0), B=2,
                          tag="[train-window W=0]", n_params=WINDOW_PARAMS)
    print(f"[train-window] W=1024 {res['step_ms']:.2f} ms/step vs full causal "
          f"{full['step_ms']:.2f} ms/step (ratio "
          f"{res['step_ms'] / full['step_ms']:.3f})")
    res["full_causal"] = full
    return counts, res


def phase_train_headce(smi, two_op):
    """The MHA step of phase 6 with ops/fused_head_ce.ENABLE set: K8 (and
    K6) in place of K5/K6, 12 K8 launches and no K5 launch in 12 steps;
    ms/step beside the two-op run of this call."""
    counts, res = phase_train(smi, tag="[train-headce]", head_ce=True)
    print(f"[train-headce] K8 loss route {res['step_ms']:.2f} ms/step vs "
          f"two-op (phase train) {two_op['step_ms']:.2f} ms/step")
    res["two_op_step_ms"] = two_op["step_ms"]
    return counts, res


# ---------------------------------------------------------------------------
# vit mode: ViT-B/16 training, ViT-S/16 inference (non-causal flash at T=197)
# ---------------------------------------------------------------------------

# the first three are timed: ViT-B/16 training, ViT-S/16 and ViT-B/16
# inference (infer-vit, infer-vit-quant)
VIT_SHAPES = ((64, 197, 12), (256, 197, 6), (256, 197, 12), (8, 17, 2),
              (64, 65, 3))


# profiler captures that one device_ms reading may take: a capture has
# come back without the kernels it traced (once a direct K2 launch's, once
# an autograd backward's), and the cause is not known; the number taken
# goes into the kernels line, so a capture that missed stays visible
PROFILE_CAPTURES = 3


def device_ms(fn, kernels=None, iters=10, captures=PROFILE_CAPTURES):
    """(device ms of one call of fn, captures taken): the profiler's kernel
    time (utils/profiling.op_breakdown), which the host's launch rate
    cannot stretch, unlike the event loop's reading of a call under about
    0.07 ms.  A capture counts only if it caught exactly `kernels` kernels
    a call over its `iters` calls (any kernel at all where kernels is
    None, for a library call); (None, captures) where none of `captures`
    did."""
    from vitrs_tpu_torch.utils import profiling
    for n in range(1, captures + 1):
        r = profiling.op_breakdown(fn, iters)
        if r["busy_ms"] and (kernels is None
                             or r["kernels"] == kernels * iters):
            return r["busy_ms"], n
    return None, captures


def capture_census(fn, kernels, rounds=100, iters=10):
    """{kernels caught: captures} over `rounds` profiler captures of
    `iters` calls of fn, each call `kernels` kernels: how often a capture
    misses some (`device_ms` then takes another)."""
    from vitrs_tpu_torch.utils import profiling
    hist = collections.Counter(profiling.op_breakdown(fn, iters)["kernels"]
                               for _ in range(rounds))
    print(f"[kernels-vit] profiler census: {dict(sorted(hist.items()))} of "
          f"{rounds} captures of {iters} calls x {kernels} kernels")
    return {str(k): n for k, n in sorted(hist.items())}


def phase_kernels_vit():
    """K1-fwd and K2 at causal=False, vit mode's attention, against their
    plain versions at (B, T, NH) = (64, 197, 12) (ViT-B/16 training),
    (256, 197, 6) and (256, 197, 12) (ViT-S/16 and ViT-B/16 inference),
    (8, 17, 2) (the CPU test model) and (64, 65, 3) (vit-tiny-4-cifar10),
    bf16 and fp32: out as `out_errors`,
    lse 1e-4 bf16 / 1e-5 fp32, dq/dk/dv 2e-2 abs + rel bf16 / 1e-4 fp32
    (phase kernels-train's); two calls of each give the same bits.  Then,
    at the three T=197 shapes in bf16 (ViT-B/16 inference: the forward
    only): kernel and plain by events (plain, kernel, kernel, plain), the
    kernel's device time by the profiler (`device_ms`), the bound and
    SDPA's non-causal forward and backward on the same tensors, and at
    the training shape a census of 100 captures (`capture_census`).  Then
    K7 over ViT-B/16's 87,335,656 values (`adamw_at`)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for B, T, nh in VIT_SHAPES:
        Cv = nh * D
        for dtype, lse_tol, tol in ((torch.bfloat16, 1e-4, 2e-2),
                                    (torch.float32, 1e-5, 1e-4)):
            qkv = torch.randn(B, T, 3 * Cv, generator=gen, device="cuda").to(dtype)
            do = torch.randn(B, T, Cv, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(Cv, dim=-1)
            where = f"B={B} T={T} NH={nh} {str(dtype)[6:]}"
            (out, lse), (out2, lse2) = (FA.flash_fwd_cuda(q, k, v, nh, False,
                                                          0.125)
                                        for _ in range(2))
            ref, ref_lse = FA.flash_fwd_plain(q, k, v, nh, False, 0.125)
            got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, False,
                                            0.125) for _ in range(2))
            want = FA.flash_bwd_plain(q, k, v, out, lse, do, nh, False, 0.125)
            torch.cuda.synchronize()
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"K1-fwd {where}: two calls differ")
            bad, err, rms = out_errors(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            check(bad == 0, f"K1-fwd {where}: {bad} out values beyond "
                  f"tolerance")
            check(lse_err <= lse_tol, f"K1-fwd {where}: lse err {lse_err}")
            errs = []
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(a, b), f"K2 {where}: {name} differs between "
                      f"two calls")
                d = (a.float() - c.float()).abs()
                nbad = ((d > tol + tol * c.float().abs()).sum().item()
                        + (~torch.isfinite(a)).sum().item())
                check(nbad == 0, f"K2 {where}: {nbad} {name} values beyond "
                      f"{tol}")
                errs.append(d.max().item())
            print(f"[kernels-vit] {where} causal=0: out max_abs_err {err:.3e} "
                  f"(rms {rms:.3e}), lse {lse_err:.3e}; dq/dk/dv "
                  f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}; each bitwise "
                  f"equal over two calls")
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], err)
                worst["bwd"] = max(worst["bwd"], *errs)
            del qkv, do, q, k, v, out, out2, ref, got, again, want
    res = {}
    for B, T, nh in VIT_SHAPES[:3]:
        Cv = nh * D
        qkv = torch.randn(B, T, 3 * Cv, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, T, Cv, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.split(Cv, dim=-1)
        out, lse = FA.flash_fwd_cuda(q, k, v, nh, False, 0.125)
        shape = f"bf16 B={B} T={T} NH={nh} D=64 non-causal"
        kernels = {
            "fwd": (lambda: FA.flash_fwd_cuda(q, k, v, nh, False, 0.125),
                    lambda: FA.flash_fwd_plain(q, k, v, nh, False, 0.125),
                    lambda: sdpa(q, k, v, nh, nh, causal=False), 2),
            "bwd": (lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, nh,
                                              False, 0.125),
                    lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, nh,
                                               False, 0.125),
                    sdpa_bwd(q, k, v, do, nh, nh, causal=False), 5)}
        if (B, nh) == (256, 12):
            del kernels["bwd"]          # no path trains at this shape
        for part, (kern, plain, lib_fn, passes) in kernels.items():
            km, pm, raw = timed_pair(kern, plain)
            # K1-fwd is one kernel a launch, K2 three
            dev, caps = device_ms(kern, 1 if part == "fwd" else 3)
            lib = cuda_ms(lib_fn)
            lib_dev, lib_caps = device_ms(lib_fn)
            flops, (bms, by) = (
                fwd_bound(B, nh, nh, D, T, 0, T, 2, causal=False)
                if passes == 2 else
                bwd_bound(B, nh, nh, D, T, 2, causal=False))
            name = "K1-fwd" if part == "fwd" else "K2"
            check(dev is not None, f"{name} {shape}: none of "
                  f"{PROFILE_CAPTURES} traces caught its kernels")
            print(f"[kernels-vit] {name} time {shape}: kernel {raw[0]:.4f}/"
                  f"{raw[1]:.4f} ms by events, {dev:.4f} ms device "
                  f"({flops / dev / 1e9:.1f} TFLOP/s; capture {caps}); plain "
                  f"{raw[2]:.4f}/{raw[3]:.4f} ms; SDPA "
                  f"{'forward' if part == 'fwd' else 'backward'} {lib:.4f} "
                  f"ms by events, {lib_dev or 'not captured'} device (captures "
                  f"{lib_caps}); bound {bms:.4f} ms ({by})")
            res.setdefault(part, {})[(B, nh)] = dict(
                ms=km, device_ms=dev, device_captures=caps, plain_ms=pm,
                library_ms=lib, library_device_ms=lib_dev,
                library_device_captures=lib_caps, bound_ms=bms, bound_by=by,
                tflops_device=flops / dev / 1e9, shape=shape)
            if (B, nh) == (64, 12):
                res[part][(B, nh)]["capture_census"] = capture_census(
                    kern, 1 if part == "fwd" else 3)
        del qkv, do, q, k, v, out, lse
    b16 = res["fwd"].pop((256, 12))
    for part in ("fwd", "bwd"):
        res[part] = dict(max_abs_err=worst[part], **res[part].pop((64, 12)),
                         infer_shape=res[part].pop((256, 6)))
    res["fwd"]["infer_vit_b16_shape"] = b16
    res["adamw"] = adamw_at((VIT_B16_PARAMS,), gen, "kernels-vit")
    return res


def adamw_at(ns, gen, tag, weight_decay=0.05):
    """K7 against its plain version over each n of `ns` fp32 values (rtol
    2e-6, atol 1e-9: the same fp32 operations in the same order), then at
    the last n: kernel and plain times (plain, kernel, kernel, plain),
    AdamW(fused=True).step on the same tensors, and the bound (reads p, g,
    m, v and writes p, m, v: 28 bytes a value; about 16 fp32 operations
    each)."""
    from vitrs_tpu_torch.ops import fused_adamw as FW
    worst = 0.0
    for n in ns:
        p, gr, m = (torch.randn(n, generator=gen, device="cuda")
                    for _ in range(3))
        v = torch.rand(n, generator=gen, device="cuda")
        want = FW.adamw_plain(p.clone(), gr, m.clone(), v.clone(), 7, 3e-4,
                              weight_decay=weight_decay)
        got = FW.adamw_cuda(p, gr, m, v, 7, 3e-4, weight_decay=weight_decay)
        torch.cuda.synchronize()
        for name, a, b in zip("pmv", got, want):
            err = (a - b).abs()
            bad = (err > 1e-9 + 2e-6 * b.abs()).sum().item()
            check(bad == 0, f"K7 n={n}: {bad} {name} values beyond tolerance")
            worst = max(worst, err.max().item())
        print(f"[{tag}] K7 n={n}: p/m/v within rtol 2e-6 "
              f"(max_abs_err {worst:.3e})")
        del want
    km, pm, raw = timed_pair(
        lambda: FW.adamw_cuda(p, gr, m, v, 7, 3e-4, weight_decay=weight_decay),
        lambda: FW.adamw_plain(p, gr, m, v, 7, 3e-4,
                               weight_decay=weight_decay))
    leaf = p.detach().clone().requires_grad_(True)
    leaf.grad = gr
    lib_opt = torch.optim.AdamW([leaf], lr=3e-4, weight_decay=weight_decay,
                                fused=True)
    lib = cuda_ms(lib_opt.step)
    bms, by = bound(16 * n, "fp32", 28 * n)
    print(f"[{tag}] K7 time n={n} fp32: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, AdamW(fused=True).step "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=worst, ms=km, plain_ms=pm, bound_ms=bms,
                bound_by=by, library_ms=lib, shape=f"fp32 n={n}")


def phase_infer_vit(smi, steps=20):
    """vit-s-16 (22,434,664 parameters, seeded random weights) in bf16 at
    B=256 through the infer CLI's function (cli/infer.run: one warm-up
    forward, then `steps`): 12 K1-fwd and 12 GELU launches a forward and
    no other kernel, finite logits; the first 4 images' logits within 5e-2 (of
    their largest value) of the same model's fp32 forward on the CPU (the
    plain versions).  Prints images/s, latency, MFU on forward FLOPs, and
    peak memory."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.cli import infer
    from vitrs_tpu_torch.config import get_config
    cfg = get_config("vit-s-16")
    check(P.num_parameters(cfg) == 22_434_664, "vit-s-16 parameter count")
    reset_counts()
    rec = infer.run("vit-s-16", batch_size=256, steps=steps,
                    dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    logits = rec.pop("logits")
    L = cfg.num_layers
    want = designed(flash_fwd=L * (steps + 1), gelu_fwd=L * (steps + 1))
    check(counts == want, f"[infer-vit] launches {counts} != designed {want}")
    check(tuple(logits.shape) == (256, 1000)
          and bool(torch.isfinite(logits).all()), "[infer-vit] logits")
    ref = infer.run("vit-s-16", batch_size=4, steps=1, dtype="float32",
                    device="cpu")["logits"]
    err = ((logits[:4].float().cpu() - ref).abs().max()
           / ref.abs().max()).item()
    check(err <= 5e-2, f"[infer-vit] bf16 logits vs fp32 CPU: {err}")
    print(f"[infer-vit] vit-s-16 bf16 B=256: {rec['value']} images/s, "
          f"latency {rec['latency_ms']} ms a batch, MFU {rec['mfu']} (forward "
          f"FLOPs, 989 TFLOP/s), peak {rec['peak_mem_gib']} GiB; "
          f"{counts['flash_fwd'] // (steps + 1)} K1-fwd launches a forward; "
          f"logits vs fp32 CPU {err:.3e} of their largest  ({smi})")
    return counts, rec


VIT_B16_PARAMS = 87_335_656


def phase_xdevice_vit():
    """One vit training step of a small fp32 model (img 32, patch 4, T=65,
    2 heads of 64, CLS pool, 2 layers, 10 classes) on CUDA with the kernels
    and on the CPU with the plain versions, from the same weights and the
    same uint8 batch (normalised on each device): plain; with mixup
    (lambda and the permutation drawn on the host, `mixup_draw`); with
    stochastic depth 0.5 and head dropout 0.2 (flags from the step's CPU
    generator, `step_generator`, so both devices drop the same branches).
    Loss, all 21 gradients and the updated parameters agree within phase
    xdevice-train's tolerances; each CUDA step launches 2L K1-fwd, 2L K2
    and one K7 (the gradients' pass, then the step's)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data import datasets as DS
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp
    base = get_config("vit-tiny-4-cifar10").replace(
        num_layers=2, num_heads=2, channels=128, dtype="float32")
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 8)
    stats = (DS.CIFAR10_MEAN, DS.CIFAR10_STD)
    lr = 1e-3
    variants = (("plain", base, 0.0),
                ("mixup", base, 0.4),
                ("drop-path", base.replace(drop_path=0.5, drop_rate=0.2), 0.0))
    all_counts = {}
    for tag, cfg, alpha in variants:
        params = P.init_params(cfg, torch.Generator().manual_seed(5))
        out = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            leaves = {k: v.to(dev).requires_grad_(True)
                      for k, v in params.items()}
            xd = dp.normalize_images(torch.as_tensor(x, device=dev), *stats)
            yd = torch.as_tensor(y, device=dev)
            if alpha:
                lam, perm = dp.mixup_draw(alpha, 1, 8)
                loss = dp.mixup_loss(leaves, xd, yd, lam,
                                     torch.as_tensor(perm, device=dev), cfg)
            else:
                loss = M.loss_fn(leaves, xd, yd, cfg,
                                 generator=dp.step_generator(1))
            loss.backward()
            flat = P.flatten_params(params, cfg).to(dev)
            mesh = dp.make_mesh(devices=[dev])
            m, v = dp.init_sharded_opt_state(cfg, mesh)
            step = dp.make_dp_train_step(cfg, mesh, clip_norm=1.0,
                                         mixup_alpha=alpha, normalize=stats)
            new, _, _, step_loss = step(P.unflatten_params(flat, cfg), m, v,
                                         x, y, 1, lr, 0.05)
            out[dev] = (loss.item(),
                        {k: torch.zeros(t.shape) if t.grad is None
                         else t.grad.cpu() for k, t in leaves.items()},
                        {k: t.detach().cpu() for k, t in new.items()},
                        step_loss.item(), read_counts())
        L = cfg.num_layers
        want = designed(flash_fwd=2 * L, flash_bwd=2 * L, adamw=1,
                        gelu_fwd=2 * L, gelu_bwd=2 * L)
        check(out["cuda"][4] == want, f"xdevice-vit {tag}: CUDA launches "
              f"{out['cuda'][4]}")
        check(not any(out["cpu"][4].values()),
              f"xdevice-vit {tag}: a kernel ran on CPU")
        all_counts[tag] = out["cuda"][4]
        gerr, perr = compare_steps(f"xdevice-vit {tag}", out["cuda"],
                                   out["cpu"], lr)
        print(f"[xdevice-vit] {tag}: fp32 L=2 NH=2 T=65: loss "
              f"{out['cuda'][0]:.6f} (cuda) vs {out['cpu'][0]:.6f} (cpu); "
              f"{len(out['cpu'][1])} grads max_abs_err {gerr:.3e}; params "
              f"after one AdamW step max_abs_err {perr:.3e}")
    return all_counts


# ---------------------------------------------------------------------------
# mixture of experts (gpt2-moe-8e) and the tree optimizers (Adafactor, Muon)
# ---------------------------------------------------------------------------

MOE_PARAMS = 521_197_824
MOE_B = 24              # bench.py's MoE row (bench.py:155-158)


def exact_check(what, q, k, v, out, ref, sm_scale, limit=64):
    """Hold K1-fwd's causal output (B, T, C, bf16) to its plain version
    (`out_errors`), and each value beyond that bound to the exact value of
    its row, the softmax in fp64 over the same bf16 q^ = q * sm_scale, k
    and v: the kernel must lie within 2^-8 (sum_j p_j |v_j| + |exact|) of
    it, the error its own bf16 rounding of p (2^-9 a term) and of the
    output allows.  `out_errors` assumes no cancellation within a row; a
    row whose output is small against its terms can put the two bf16
    versions further apart than that, with the kernel the nearer one (a
    row at t=113 of B=4 T=4096: plain 1.26e-3 from exact, kernel 6.9e-4).
    More than `limit` such values fail outright.  Returns a summary of the
    values so held."""
    bad_idx = []
    bad, _, _ = out_errors(out, ref)
    if bad:
        g, w = out.float(), ref.float()
        rms = w.square().mean().sqrt()
        lim = (2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 2.0 ** -6 * rms)
        bad_idx = ((g - w).abs() > lim).nonzero().tolist()
    check(len(bad_idx) <= limit, f"{what}: {len(bad_idx)} out values beyond "
          f"tolerance")
    worst = 0.0
    for b, t, c in bad_idx:
        h = c // D
        qh = (q[b, t, h * D:(h + 1) * D].double() * sm_scale).to(
            torch.bfloat16).double()
        p = torch.softmax(k[b, :t + 1, h * D:(h + 1) * D].double() @ qh, 0)
        vc = v[b, :t + 1, c].double()
        exact = (p @ vc).item()
        allowed = 2.0 ** -8 * ((p @ vc.abs()).item() + abs(exact))
        d = abs(out[b, t, c].item() - exact)
        check(d <= allowed, f"{what}: out[{b}, {t}, {c}] = "
              f"{out[b, t, c].item()} is {d:.3e} from the fp64 value "
              f"{exact}, beyond {allowed:.3e}")
        worst = max(worst, d / allowed)
    return f"{len(bad_idx)} held, worst {worst:.3f} of the allowance"


def train_kernel_rows(tag, B, T, gen):
    """K1-fwd, K2 (bf16 B x T, NH=12 D=64 causal) and K5, K6 (the loss over
    R = B*T rows of the 50,304-column padded head) at a training shape,
    each against its plain version at phase kernels' and kernels-train's
    tolerances, then kernel and plain times (plain, kernel, kernel, plain)
    beside the bound and PyTorch's call (SDPA's forward and backward,
    F.cross_entropy).  Returns {kernel name: its row's numbers}."""
    import torch.nn.functional as F
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import fused_ce as CE
    shape = f"bf16 B={B} T={T} NH=12 D=64 causal"
    res = {}
    qkv = torch.randn(B, T, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.split(C, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, True, 0.125)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, True, 0.125)
    torch.cuda.synchronize()
    bad, err, rms = out_errors(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    judged = exact_check(f"K1-fwd {shape}", q, k, v, out, ref, 0.125)
    check(lse_err <= 1e-4, f"K1-fwd {shape}: lse err {lse_err}")
    del ref, ref_lse
    km, pm, raw = timed_pair(
        lambda: FA.flash_fwd_cuda(q, k, v, NH, True, 0.125),
        lambda: FA.flash_fwd_plain(q, k, v, NH, True, 0.125))
    lib = cuda_ms(lambda: sdpa(q, k, v, NH, NH))
    flops = fwd_flops(B, T, 0, T)
    bms, by = fwd_bound(B, NH, NH, D, T, 0, T, 2)[1]
    res["flash_fwd"] = dict(max_abs_err=err, ms=km, plain_ms=pm, bound_ms=bms,
                            bound_by=by, library_ms=lib,
                            tflops=flops / km / 1e9, shape=shape,
                            beyond_out_errors=bad, held_to_fp64=judged)
    print(f"[{tag}] K1-fwd {shape}: out max_abs_err {err:.3e} (rms "
          f"{rms:.3e}), {bad} values beyond out_errors held to the fp64 "
          f"softmax ({judged}), lse {lse_err:.3e}; kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} "
          f"ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), {flops / km / 1e9:.1f} TFLOP/s")

    do = torch.randn(B, T, C, generator=gen, device="cuda").to(torch.bfloat16)
    got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True, 0.125)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, 0.125)
    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        d = (a.float() - b.float()).abs()
        bad = (d > 2e-2 + 2e-2 * b.float().abs()).sum().item()
        check(torch.isfinite(a).all().item() and bad == 0,
              f"K2 {shape}: {bad} {name} values beyond 2e-2")
        errs.append(d.max().item())
    del got, want
    km, pm, raw = timed_pair(
        lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True, 0.125),
        lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, 0.125))
    lib = cuda_ms(sdpa_bwd(q, k, v, do, NH, NH))
    flops = bwd_flops(B, T)
    bms, by = bwd_bound(B, NH, NH, D, T, 2)[1]
    res["flash_bwd"] = dict(max_abs_err=max(errs), ms=km, plain_ms=pm,
                            bound_ms=bms, bound_by=by, library_ms=lib,
                            tflops=flops / km / 1e9, shape=shape)
    print(f"[{tag}] K2 {shape}: max_abs_err dq/dk/dv "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}; kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"SDPA backward {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
          f"{flops / km / 1e9:.1f} TFLOP/s")
    del qkv, q, k, v, out, lse, do

    R, V = B * T, 50257
    Vp = CE.pad_vocab(V)
    logits = (3 * torch.randn(R, Vp, generator=gen, device="cuda")).to(
        torch.bfloat16)
    targets = torch.randint(0, V, (R,), generator=gen, device="cuda")
    g = torch.full((R,), 1.0 / R, device="cuda")
    lse, picked = CE.ce_fwd_cuda(logits, targets, V)
    want_lse, want_picked = CE.ce_fwd_plain(logits, targets, V)
    d = CE.ce_bwd_cuda(logits, targets, lse, g, V)
    want_d = CE.ce_bwd_plain(logits, targets, lse, g, V)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    pick_err = (picked - want_picked).abs().max().item()
    derr = (d.float() - want_d.float()).abs()
    bad = (derr > 1e-6 + 2 ** -8 * want_d.float().abs()).sum().item()
    check(lse_err <= 1e-4 and pick_err == 0.0,
          f"K5 R={R}: lse err {lse_err}, picked err {pick_err}")
    check(bad == 0 and bool((d[:, V:] == 0).all()),
          f"K6 R={R}: {bad} dlogits values beyond one bf16 ulp, or pad != 0")
    derr = derr.max().item()
    del want_d, want_lse, want_picked
    shape = f"bf16 R={R} Vp={Vp} real_vocab={V}"
    km, pm, raw = timed_pair(lambda: CE.ce_fwd_cuda(logits, targets, V),
                             lambda: CE.ce_fwd_plain(logits, targets, V))
    lib = cuda_ms(lambda: F.cross_entropy(logits[:, :V], targets,
                                          reduction="none"))
    bms, by = bound(4 * R * V, "fp32", R * V * 2 + R * 8 + 2 * R * 4)
    res["ce_fwd"] = dict(max_abs_err=lse_err, ms=km, plain_ms=pm,
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         shape=shape)
    print(f"[{tag}] K5 {shape}: lse max_abs_err {lse_err:.3e}; kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"F.cross_entropy {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    km, pm, raw = timed_pair(
        lambda: CE.ce_bwd_cuda(logits, targets, lse, g, V),
        lambda: CE.ce_bwd_plain(logits, targets, lse, g, V))
    bms, by = bound(5 * R * V, "fp32", R * V * 2 + R * Vp * 2 + R * 16)
    res["ce_bwd"] = dict(max_abs_err=derr, ms=km, plain_ms=pm, bound_ms=bms,
                         bound_by=by, library_ms=None, shape=shape)
    print(f"[{tag}] K6 {shape}: dlogits max_abs_err {derr:.3e}; kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    return res


def phase_kernels_moe():
    """K1-fwd, K2, K5 and K6 at the MoE training shapes, gpt2-moe-8e at
    bench.py's B=24, T=1024 (`train_kernel_rows`: the loss over R=24,576
    rows); K4 at serve-moe's chunked generate (bf16 B=1, 256-query chunks
    at q_offset 256 and 512 into a 1024-slot cache, 12 kv heads) against
    its plain version, then times beside the bound and SDPA with a mask."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = train_kernel_rows("kernels-moe", MOE_B, 1024, gen)

    # K4 at serve-moe's chunked generate: a 768-token prompt in 256-token
    # chunks (the 2nd and 3rd at q_offset 256 and 512) into a 1024-slot
    # bf16 cache, every slot past the chunk NaN; tolerance `out_errors`
    from vitrs_tpu_torch.ops import flash_prefill as FP
    B, S, Tk, KH = 1, 256, 1024, NH
    shape = f"bf16 B={B} S={S} q_off=512 Tk={Tk} NH=12 KH={KH} D=64"
    worst = 0.0
    for q_off in (256, 512):
        q = torch.randn(B, S, C, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(B, Tk, KH * D, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        k[:, q_off + S:] = float("nan")
        v[:, q_off + S:] = float("nan")
        got = FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125)
        want = FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125)
        torch.cuda.synchronize()
        bad, err, rms = out_errors(got, want)
        check(torch.isfinite(got).all().item() and bad == 0,
              f"K4 B={B} S={S} q_off={q_off} Tk={Tk}: {bad} values beyond "
              f"tolerance, or non-finite")
        print(f"[kernels-moe] K4 bf16 B={B} S={S} q_off={q_off} Tk={Tk} "
              f"KH={KH} (NaN tail): max_abs_err {err:.3e} (rms {rms:.3e})")
        worst = max(worst, err)
    front = q_off + S
    mask = (torch.arange(front, device="cuda")[None, :]
            <= q_off + torch.arange(S, device="cuda")[:, None])
    km, pm, raw = timed_pair(
        lambda: FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125),
        lambda: FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125))
    lib = cuda_ms(lambda: sdpa(q, k[:, :front], v[:, :front], NH, KH, mask=mask))
    bms, by = fwd_bound(B, NH, KH, D, S, q_off, Tk, 2)[1]
    flops = fwd_flops(B, S, q_off, Tk)
    res["flash_prefill"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                                bound_ms=bms, bound_by=by, library_ms=lib,
                                tflops=flops / km / 1e9, shape=shape)
    print(f"[kernels-moe] K4 {shape}: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA (mask) {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by}), {flops / km / 1e9:.1f} TFLOP/s")
    return res


def _moe_cfg():
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    cfg = get_config("gpt2-moe-8e", moe_cap_factor=1.0, dtype="bfloat16")
    check(P.num_parameters(cfg) == MOE_PARAMS, "gpt2-moe-8e parameter count")
    return cfg


def _moe_breakdown(cfg, B):
    """utils/profiling's device-time breakdown of one Adafactor step of
    gpt2-moe-8e at B on the synthetic token stream (seeded weights made on
    the card), the step's Adafactor state bytes, and the Adafactor update
    alone (ops/adafactor.step on the step's gradients, CUDA events)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.data import tokens as TOK
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.parallel import data_parallel as dp
    from vitrs_tpu_torch.utils import profiling
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = P.unflatten_params(P.flatten_params(params, cfg), cfg)
    state = AF.init_state(params)
    step = dp.make_dp_train_step_adafactor(cfg, dp.make_mesh(devices=["cuda"]))
    x, y = TOK.TokenLoader(TOK.get_tokens(None, cfg.vocab_size, seed=0), B,
                           cfg.max_seq_len).next_batch()
    prof = profiling.op_breakdown(
        lambda: step(params, state, x, y, 1, 1e-2, 0.1), 3)
    grads = {k: t.grad for k, t in params.items()}
    mask = {k: t.dim() >= 2 for k, t in params.items()}
    af_ms = cuda_ms(lambda: AF.step(params, grads, state, 1, 1e-2,
                                    weight_decay=0.1, decay_mask=mask),
                    iters=5, warmup=1)
    return prof, AF.state_bytes(state), af_ms


def phase_train_moe(smi, steps=12):
    """gpt2-moe-8e (521,197,824 parameters: GPT-2 124M's trunk with 8
    experts a layer, top-2) at full width and depth as bench.py's MoE row
    runs it (bench.py:155-158: B=24, T=1024, Adafactor, moe_cap_factor 1.0,
    so 6,144 slots an expert a layer), fp32 masters, bf16 compute, 12 steps
    of train/loop.train with Adafactor at the relative step 1e-2 the CLI
    documents (cosine to 1e-3, warmup 2, decay 0.1 on the >= 2-axis
    tensors), on the synthetic token stream.  Finite loss, lower at step 12
    than at step 1; 12 K1-fwd, 12 K2, 1 K5 and 1 K6 a step, no K7 or K8.
    Prints step ms and tok/s (median of steps 3-12), sparse MFU
    (utils/flops: the executed top-2 expert products), peak memory, the
    router's kept fraction (each layer's share of assignments within
    capacity), the Adafactor state's bytes beside AdamW's m + v, and the
    device-time breakdown of one step (utils/profiling, with the
    index/gather group of the MoE routing)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.train import loop
    cfg = _moe_cfg()
    B, T, L = MOE_B, cfg.max_seq_len, cfg.num_layers
    kept = []
    real = M.moe_mlp

    def recording(*a, **kw):
        out, aux = real(*a, **kw)
        kept.append(aux.kept_fraction.detach())
        return out, aux

    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="gpt2-moe-8e", dataset="", steps=steps,
                              batch_size=B, lr=1e-2, warmup=2, min_lr=1e-3,
                              weight_decay=0.1, dtype="bfloat16",
                              log_every=1, ckpt_every=0, workdir=work,
                              optimizer="adafactor", device="cuda",
                              model_overrides={"moe_cap_factor": 1.0})
        torch.cuda.reset_peak_memory_stats()
        M.moe_mlp = recording
        reset_counts()
        t0 = time.perf_counter()
        try:
            loop.train(tc)
            torch.cuda.synchronize()
        finally:
            M.moe_mlp = real
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    want = designed(flash_fwd=L * steps, flash_bwd=L * steps, ce_fwd=steps,
                    ce_bwd=steps, gelu_fwd=L * steps, gelu_bwd=L * steps)
    check(counts == want, f"[train-moe] launches {counts} != designed {want}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"[train-moe] losses {losses}")
    check(losses[-1] < losses[0], f"[train-moe] loss did not fall: {losses}")
    kept = torch.stack(kept).float().cpu().reshape(steps, L)
    steady = recs[2:]
    tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
    mfu = float(np.median([r["mfu"] for r in steady]))
    step_ms = B * T / tok_s * 1e3
    print(f"[train-moe] gpt2-moe-8e ({MOE_PARAMS} params, E=8 top-2, cap "
          f"factor 1.0: 6144 slots an expert) bf16/fp32-master B={B} T={T} "
          f"Adafactor {steps} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; lr (relative step) {[r['lr'] for r in recs]}")
    print(f"[train-moe] losses {losses}")
    print(f"[train-moe] launches per step: flash_fwd "
          f"{counts['flash_fwd'] // steps}, flash_bwd "
          f"{counts['flash_bwd'] // steps} (3 kernels each), gelu_fwd / "
          f"gelu_bwd as many, ce_fwd/ce_bwd 1, adamw and every other kernel "
          f"0")
    print(f"[train-moe] steady (steps 3-{steps}, median): {step_ms:.2f} "
          f"ms/step, {tok_s:.1f} tok/s, sparse MFU {mfu:.4f} of 989 TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} s "
          f"incl. init and final checkpoint  ({smi})")
    print(f"[train-moe] per-step tok/s {[r['tok_per_sec'] for r in recs]}")
    print(f"[train-moe] router kept fraction: mean {kept.mean():.4f}, min "
          f"{kept.min():.4f}, max {kept.max():.4f}; step 12 by layer "
          f"{[round(float(x), 4) for x in kept[-1]]}")
    del recs
    torch.cuda.empty_cache()
    prof, state_bytes, af_ms = _moe_breakdown(cfg, B)
    adamw_bytes = 8 * P.num_parameters(cfg)
    print(f"[train-moe] Adafactor state {state_bytes} B against AdamW's m + "
          f"v {adamw_bytes} B ({state_bytes / adamw_bytes:.5f}); the "
          f"Adafactor update alone {af_ms:.3f} ms")
    print(f"[train-moe] breakdown of one step (device ms): "
          f"{json.dumps(prof)}  ({smi})")
    return counts, dict(step_ms=step_ms, tok_s=tok_s, mfu=mfu,
                        peak_gib=peak / 2**30, losses=losses,
                        kept_mean=float(kept.mean()),
                        kept_min=float(kept.min()),
                        state_bytes=state_bytes, adamw_state_bytes=adamw_bytes,
                        adafactor_ms=af_ms, breakdown=prof)


def phase_serve_moe(smi):
    """gpt2-moe-8e in bf16 (seeded random weights, cap factor 1.0): 8
    greedy requests through GenerationEngine (phase serve's prompts, 32 new
    tokens, decode chunk 16): K1-fwd launches == 12 x prefill dispatches,
    every block's MLP the routed MoE layer (capacity from each call's own
    tokens: a prefill's, a decode tick's 8 slots).  Then generate() of a
    768-token prompt, whole and in 256-token chunks (one K1-fwd chunk, two
    K4 chunks under MoE), 1 and 33 new tokens: finite logits, valid ids;
    prefill ms and ms per new token."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    cfg = _moe_cfg()
    L = cfg.num_layers
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    pp = M.prepare_params(params, cfg)
    del params
    rng = np.random.default_rng(0)
    lengths = (5, 37, 128, 300, 511, 700, 900, 960)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    def serve():
        eng = GenerationEngine(pp, cfg, max_slots=8, max_len=1024,
                               prompt_buckets=(128, 512, 1024),
                               decode_chunk=16)
        for p in prompts:
            eng.submit(p, max_new=32)
        reset_counts()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = dict(eng.run())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        want = designed(flash_fwd=L * eng.prefill_dispatches,
                        gelu_fwd=L * (eng.prefill_dispatches
                                      + eng.decode_ticks))
        check(counts["flash_fwd"] > 0 and counts == want,
              f"[serve-moe] launches {counts} != {want}")
        for i, n in enumerate(lengths):
            gen = outs[i][n:]
            check(len(outs[i]) == n + 32 and bool(
                ((gen >= 0) & (gen < cfg.vocab_size)).all()),
                f"[serve-moe] request {i}")
        return eng, counts, (t1 - t0) * 1e3, 8 * 32 / (t2 - t1)

    serve()                                    # warm-up: cuBLAS, allocator
    eng, counts, prefill_ms, tok_s = serve()
    print(f"[serve-moe] gpt2-moe-8e bf16, 8 requests x 32 new: "
          f"{eng.prefill_dispatches} prefill dispatches, {counts['flash_fwd']} "
          f"K1-fwd launches, prefill {prefill_ms:.3f} ms, decode {tok_s:.1f} "
          f"tok/s  ({smi})")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 768)),
                             device="cuda")

    def run(chunk, max_new):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(pp, prompt, cfg, max_new, temperature=0.0,
                         prefill_chunk=chunk)
        torch.cuda.synchronize()
        gen = out[:, 768:]
        check(out.shape == (1, 768 + max_new) and bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all()), "[serve-moe] ids")
        return (time.perf_counter() - t0) * 1e3, read_counts()

    run(256, 2)
    run(0, 2)
    gen_res = {}
    for chunk in (256, 0):
        ms1, c1 = run(chunk, 1)
        msn, cn = run(chunk, 33)
        chunks = 768 // chunk if chunk else 1
        want = designed(flash_fwd=L, flash_prefill=L * (chunks - 1),
                        gelu_fwd=L * chunks)
        wantn = dict(want, gelu_fwd=L * (chunks + 32))
        check(c1 == want and cn == wantn, f"[serve-moe] generate chunk "
              f"{chunk}: {c1} / {cn} != {want} / {wantn}")
        gen_res[chunk] = dict(prefill_ms=ms1, ms_per_new_token=(msn - ms1) / 32,
                              launches=c1)
        print(f"[serve-moe] generate 768-token prompt, chunk {chunk}: "
              f"launches flash_fwd {c1['flash_fwd']}, flash_prefill "
              f"{c1['flash_prefill']}; prefill (max_new=1) {ms1:.2f} ms; "
              f"{(msn - ms1) / 32:.3f} ms per new token  ({smi})")
    caches = G.init_kv_cache(cfg, 1, 1024, device=prompt.device)
    lg, _ = G.forward_with_cache(pp, prompt, caches, 0, cfg, last_only=True)
    check(bool(torch.isfinite(lg).all()), "[serve-moe] non-finite logits")
    return dict(launches=counts, prefill_ms=prefill_ms, decode_tok_s=tok_s,
                generate=gen_res)


def _moe_step_on(dev, cfg, params, x, y, optimizer):
    """One tree-optimizer step of `cfg` on `dev` from `params` (CPU fp32
    tensors): (loss, grads, params after, state after, the router's dst of
    every MoE call, launches).  Adafactor at lr 1e-2, wd 0.1; Muon at lr
    0.02, AdamW lr 1e-3, clip 1.0, wd 0.1."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.ops import moe as MOE
    from vitrs_tpu_torch.ops import muon as MU
    from vitrs_tpu_torch.parallel import data_parallel as dp
    mesh = dp.make_mesh(devices=[dev])
    flat = P.flatten_params({k: t.to(dev) for k, t in params.items()}, cfg)
    leaves = P.unflatten_params(flat, cfg)
    if optimizer == "adafactor":
        step = dp.make_dp_train_step_adafactor(cfg, mesh)
        args = (AF.init_state(leaves), x, y, 1, 1e-2, 0.1)
    else:
        step = dp.make_dp_train_step_muon(cfg, mesh, clip_norm=1.0,
                                          weight_decay=0.1)
        args = (MU.init_state(leaves), x, y, 0, 0.02, 1e-3)
    dsts, real = [], MOE.router

    def recording(*a):
        out = real(*a)
        dsts.append(out[0].cpu())
        return out

    MOE.router = recording
    reset_counts()
    try:
        new, state, loss = step(leaves, *args)
        counts = read_counts()
    finally:
        MOE.router = real
    cpu = lambda tree: {k: t.detach().cpu() for k, t in tree.items()}  # noqa: E731
    return (loss.item(), {k: t.grad.cpu() for k, t in new.items()}, cpu(new),
            {f: cpu(tree) for f, tree in state._asdict().items()}, dsts,
            counts)


def phase_xdevice_moe():
    """A small fp32 MoE model (L=2, 2 heads of 64, C=128, E=4, top-2, cap
    factor 1.0, so some assignments are dropped; V=16500: the fused CE
    route) on CUDA with the kernels and on the CPU with the plain versions,
    from the same weights and tokens (TF32 off):
      * one Adafactor step and one Muon step: the same router dst in every
        MoE call, then the loss (rtol 1e-5), every gradient (rtol 1e-4 +
        atol 1e-6, the packed qkv bias atol 2e-4: its k third's gradient
        is exactly 0, so both hold fp32 noise), the parameters after the
        step and the optimizer state.  Adafactor: rtol 1e-4 + atol 5e-5
        (the CPU parity tests'), qkvb on its q and v thirds (Adafactor
        scales noise to a full step); state rtol 1e-4 + 1e-5 of each
        tensor's largest value.  Muon: the bf16 Newton-Schulz products sum
        in another order on each device, which flips bf16 roundings and
        grows over five iterations (tests/test_torch_muon.py), so each
        matrix's update agrees within 5% of its norm and 1e-3 elementwise
        (the CPU parity test's; a lost aspect scale, Nesterov term or decay
        is off by the order of the update, up to 0.02);
        the rest rtol 2e-5 + atol 1e-6, or the AdamW lr where |g| < 1e-6;
        momentum and AdamW moments as Adafactor's state.  Each CUDA step launches L K1-fwd, L K2, one K5
        and one K6, and no K7;
      * a chunked generate (48-token prompt, chunk 16, 8 new): the same
        greedy tokens; K1-fwd and K4 on CUDA only;
      * `moe_mlp` on the card in bf16 at (S, C, E) = (8192, 768, 8), top-2,
        cap factor 1.0, forward and backward twice: the same bits (the
        gather-only backward; autograd's index_add_ would use atomics)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops import moe as MOE
    from vitrs_tpu_torch.ops import muon as MU
    cfg = get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=128, max_seq_len=64,
        vocab_size=16500, num_experts=4, moe_top_k=2, moe_cap_factor=1.0)
    L, C_ = cfg.num_layers, cfg.channels
    params = P.init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    x = rng.integers(0, cfg.vocab_size, (2, 64))
    y = rng.integers(0, cfg.vocab_size, (2, 64))
    out = {}
    for optimizer in ("adafactor", "muon"):
        got = _moe_step_on("cuda", cfg, params, x, y, optimizer)
        want = _moe_step_on("cpu", cfg, params, x, y, optimizer)
        tag = f"xdevice-moe {optimizer}"
        check(got[5] == designed(flash_fwd=L, flash_bwd=L, ce_fwd=1,
                                 ce_bwd=1, gelu_fwd=L, gelu_bwd=L),
              f"{tag}: CUDA launches {got[5]}")
        check(not any(want[5].values()), f"{tag}: a kernel ran on the CPU")
        check(len(got[4]) == len(want[4]) == L and all(
            torch.equal(a, b) for a, b in zip(got[4], want[4])),
            f"{tag}: router dst differs")
        sink = cfg.num_experts * MOE.capacity(128, cfg.num_experts, 2, 1.0)
        kept = float(np.mean([(d < sink).float().mean() for d in got[4]]))
        check(kept < 1.0, f"{tag}: no assignment dropped")
        check(abs(got[0] - want[0]) <= 1e-5 * abs(want[0]),
              f"{tag}: loss {got[0]} vs {want[0]}")
        gerr = perr = serr = murel = 0.0
        for k, w in want[1].items():
            d = (got[1][k] - w).abs()
            atol = 2e-4 if k == "qkvb" else 1e-6
            check(bool((d <= atol + 1e-4 * w.abs()).all()),
                  f"{tag}: grad {k} max err {d.max().item()}")
            gerr = max(gerr, d.max().item())
        for k, w in want[2].items():
            a = got[2][k]
            if optimizer == "adafactor":
                if k == "qkvb":
                    a, w = (torch.cat([t[:, :C_], t[:, 2 * C_:]], -1)
                            for t in (a, w))
                tol = 5e-5 + 1e-4 * w.abs()
            elif k in MU.MUON_KEYS:
                p0 = params[k]
                rel = ((a - w).norm() / (w - p0).norm()).item()
                check(rel <= 5e-2, f"{tag}: {k} update differs by {rel} of "
                      f"its norm")
                murel = max(murel, rel)
                tol = torch.full_like(w, 1e-3)
            else:
                tol = torch.where(want[1][k].abs() < 1e-6,
                                  torch.full_like(w, 1e-3),
                                  1e-6 + 2e-5 * w.abs())
            d = (a - w).abs()
            check(bool((d <= tol).all()),
                  f"{tag}: param {k} max err {d.max().item()}")
            perr = max(perr, d.max().item())
        for f, tree in want[3].items():
            for k, w in tree.items():
                d = (got[3][f][k] - w).abs()
                tol = 1e-4 * w.abs() + 1e-5 * w.abs().max()
                check(bool((d <= tol).all()),
                      f"{tag}: state {f}[{k}] max err {d.max().item()}")
                serr = max(serr, (d / w.abs().max().clamp_min(1e-30)).max()
                           .item())
        out[optimizer] = got[5]
        print(f"[xdevice-moe] {optimizer}: fp32 L=2 E=4 top-2 cap 1.0 (kept "
              f"{kept:.4f}): dst equal in {L} MoE calls; loss {got[0]:.6f} "
              f"(cuda) vs {want[0]:.6f} (cpu); {len(want[1])} grads "
              f"max_abs_err {gerr:.3e}; params after the step max_abs_err "
              f"{perr:.3e}" + (f" (Muon updates within {murel:.3e} of their "
                               f"norm)" if murel else "") +
              f"; state max err {serr:.3e} of each tensor's largest")

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 48)))
    toks = {}
    for dev in ("cuda", "cpu"):
        pp = M.prepare_params({k: t.to(dev) for k, t in params.items()}, cfg)
        reset_counts()
        toks[dev] = G.generate(pp, prompt.to(dev), cfg, 8, temperature=0.0,
                               prefill_chunk=16).cpu()
        want = (designed(flash_fwd=L, flash_prefill=2 * L,
                         gelu_fwd=L * (3 + 7)) if dev == "cuda"
                else designed())
        check(read_counts() == want, f"xdevice-moe generate on {dev}: "
              f"{read_counts()}")
    check(torch.equal(toks["cuda"], toks["cpu"]),
          "xdevice-moe: chunked generate tokens differ")
    print("[xdevice-moe] fp32 chunked generate (chunk 16, 8 new): tokens "
          "equal on cuda and cpu")

    gen = torch.Generator(device="cuda").manual_seed(8)
    S_, Cm, E = 8192, 768, 8
    xs = torch.randn(S_, Cm, generator=gen, device="cuda").to(torch.bfloat16)
    ws = [0.05 * torch.randn(s, generator=gen, device="cuda")
          for s in ((E, Cm), (E, 4 * Cm, Cm), (E, 4 * Cm), (E, Cm, 4 * Cm),
                    (E, Cm))]
    ws = [ws[0]] + [w.to(torch.bfloat16) for w in ws[1:]]
    dout = torch.randn(S_, Cm, generator=gen, device="cuda").to(torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [xs.clone().requires_grad_(True)] + [
            w.clone().requires_grad_(True) for w in ws]
        o, aux = MOE.moe_mlp(*leaves, top_k=2, cap_factor=1.0)
        (aux.load_balance + aux.z_loss).backward(retain_graph=True)
        o.backward(dout)
        runs.append([o.detach(), aux.kept_fraction] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, "xdevice-moe: moe_mlp on the card is not bitwise repeatable")
    print(f"[xdevice-moe] moe_mlp bf16 S={S_} C={Cm} E={E} top-2 cap 1.0 "
          f"(kept {runs[0][1].item():.4f}): forward and all six gradients "
          f"bitwise equal over two calls")
    return out


# ---------------------------------------------------------------------------
# the rest of the training loop: remat, the prefetcher and the native
# pipelines, EMA, async checkpoints, streaming ImageNet shards, resume
# ---------------------------------------------------------------------------

REMAT_PARAMS = 126_799_104      # 124,439,808 + 3,072 extra wpe rows x 768
REMAT_B, REMAT_T = 4, 4096      # BASELINE.md's long-context row (its shape)
REMATS = (False, True, "full")


def phase_kernels_remat():
    """K1-fwd, K2, K5 and K6 at gpt2-124m-4k's training shapes, B=4,
    T=4096 (`train_kernel_rows`: attention causal at T=4096, the loss over
    R=16,384 rows), against their plain versions, then times beside the
    bound, SDPA and F.cross_entropy."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    return train_kernel_rows("kernels-remat", REMAT_B, REMAT_T, gen)


def _remat_grads(cfg, remat, x, y):
    """Loss and the 16 gradients of one step of cfg under `remat`, from
    seeded weights (the same for every remat), with the launches."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.models import model as M
    c = cfg.replace(remat=remat)
    params = P.init_params(c, torch.Generator().manual_seed(5))
    leaves = {k: t.cuda().requires_grad_(True) for k, t in params.items()}
    reset_counts()
    loss = M.loss_fn(leaves, x, y, c)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: t.grad for k, t in leaves.items()}, read_counts()


def phase_train_remat(smi, steps=12):
    """gpt2-124m-4k (126,799,104 parameters, T=4096), B=4, AdamW, 12 steps
    of train/loop.train under remat False, True (selective) and "full":
    step ms, tok/s, MFU, peak memory and the launches a step (K1-fwd/K2
    12/12, 12/12 and 24/12: the selective backward runs K2 from the saved
    out and lse, never K1-fwd; the full recompute runs the block forward
    twice); the three runs' losses within one bf16 ulp of the loss (2^-8
    relative: the same operations, only reductions may sum in another
    order); then one step's 16 gradients under remat True against False
    (rtol 5e-4, atol 1e-6; the K-bias rows of qkvb, whose gradient is
    exactly 0, atol 2e-4) and the selective peak below the plain one."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data import tokens as TOK
    from vitrs_tpu_torch.train import loop
    cfg = get_config("gpt2-124m-4k", dtype="bfloat16")
    check(P.num_parameters(cfg) == REMAT_PARAMS and cfg.remat is True,
          "gpt2-124m-4k: parameter count, or its preset remat")
    B, T, L = REMAT_B, REMAT_T, cfg.num_layers
    res = {}
    for remat in REMATS:
        with tempfile.TemporaryDirectory() as work:
            tc = loop.TrainConfig(preset="gpt2-124m-4k", dataset="",
                                  steps=steps, batch_size=B, lr=6e-4,
                                  warmup=2, min_lr=6e-5, weight_decay=0.1,
                                  dtype="bfloat16", log_every=1, ckpt_every=0,
                                  workdir=work, device="cuda", remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            loop.train(tc)
            torch.cuda.synchronize()
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            with open(os.path.join(work, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        fwd = L * steps * (2 if remat == "full" else 1)
        # either remat runs GELU's forward again in the backward
        want = designed(flash_fwd=fwd, flash_bwd=L * steps, ce_fwd=steps,
                        ce_bwd=steps, adamw=steps,
                        gelu_fwd=L * steps * (2 if remat else 1),
                        gelu_bwd=L * steps)
        check(counts == want, f"[train-remat {remat}] launches {counts} != "
              f"designed {want}")
        losses = [r["loss"] for r in recs]
        check(len(losses) == steps and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"[train-remat {remat}] losses {losses}")
        steady = recs[2:]
        tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
        mfu = float(np.median([r["mfu"] for r in steady]))
        res[str(remat)] = dict(counts=counts,
                               step_ms=B * T / tok_s * 1e3, tok_s=tok_s,
                               mfu=mfu, peak_gib=peak / 2**30, losses=losses,
                               fwd_per_step=counts["flash_fwd"] / steps,
                               bwd_per_step=counts["flash_bwd"] / steps)
        r = res[str(remat)]
        print(f"[train-remat] gpt2-124m-4k remat={remat} ({REMAT_PARAMS} "
              f"params) bf16/fp32-master B={B} T={T} {steps} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step K1-fwd "
              f"{r['fwd_per_step']:g}, K2 {r['bwd_per_step']:g}, GELU "
              f"{counts['gelu_fwd'] / steps:g} / {counts['gelu_bwd'] / steps:g}, "
              f"K5/K6/K7 1")
        print(f"[train-remat] remat={remat} steady (steps 3-{steps}, median): "
              f"{r['step_ms']:.2f} ms/step, {tok_s:.1f} tok/s, MFU {mfu:.4f}; "
              f"max_memory_allocated {r['peak_gib']:.3f} GiB  ({smi})")
        print(f"[train-remat] remat={remat} losses {losses}")
    base = res["False"]["losses"]
    for remat in REMATS[1:]:
        got = res[str(remat)]["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(got, base))
        check(worst <= 2 ** -8, f"[train-remat] remat={remat} losses {got} "
              f"vs remat=False {base}")
        print(f"[train-remat] remat={remat} losses vs remat=False: largest "
              f"relative difference {worst:.3e} (bound 2^-8)")
    check(res["True"]["peak_gib"] < res["False"]["peak_gib"],
          "[train-remat] selective peak memory not below the plain peak")

    # one step's gradients, selective against plain, same weights and batch
    x, y = (torch.as_tensor(a, device="cuda").long() for a in TOK.TokenLoader(
        TOK.get_tokens(None, cfg.vocab_size, seed=0), B, T).next_batch())
    l0, g0, c0 = _remat_grads(cfg, False, x, y)
    l1, g1, c1 = _remat_grads(cfg, True, x, y)
    want = designed(flash_fwd=L, flash_bwd=L, ce_fwd=1, ce_bwd=1,
                    gelu_fwd=L, gelu_bwd=L)
    check(c0 == want and c1 == dict(want, gelu_fwd=2 * L),
          f"[train-remat] gradient step launches {c0} / {c1}")
    check(abs(l1 - l0) <= 1e-6 * abs(l0), f"[train-remat] loss {l1} vs {l0}")
    worst, exact = 0.0, 0
    for k, want in g0.items():
        d = (g1[k] - want).abs()
        atol = 2e-4 if k == "qkvb" else 1e-6
        check(bool((d <= atol + 5e-4 * want.abs()).all()),
              f"[train-remat] grad {k}: max err {d.max().item()}")
        worst = max(worst, (d / (want.abs() + atol)).max().item())
        exact += int(torch.equal(g1[k], want))
    del g0, g1
    saved = res["False"]["peak_gib"] - res["True"]["peak_gib"]
    print(f"[train-remat] one step B={B} T={T}: loss {l1:.6f} (selective) vs "
          f"{l0:.6f} (plain); 16 grads within rtol 5e-4 (qkvb atol 2e-4), "
          f"largest |d| / (|want| + atol) {worst:.3e}, {exact} of 16 bitwise "
          f"equal; peak {res['True']['peak_gib']:.3f} GiB selective vs "
          f"{res['False']['peak_gib']:.3f} plain ({saved:.3f} GiB less), "
          f"{res['full']['peak_gib']:.3f} full")
    res["grads"] = dict(loss_plain=l0, loss_selective=l1, worst_rel=worst,
                        bitwise_equal=exact)
    return res


def _vit_run(steps, B, prefetch, profile_at=8):
    """ViT-B/16 through train/loop.train as phase train-vit runs it, with
    EMA 0.9999, an async checkpoint at step 6 and a Chrome trace of step
    `profile_at`, the loader behind the prefetcher (depth `prefetch`; 0:
    none).  Returns (counts, the log's records, the summary, peak bytes,
    wall s, the checkpoints and traces written)."""
    from vitrs_tpu_torch.train import loop
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="vit-b-16", dataset="synthetic-imagenet",
                              dataset_size=B, steps=steps, batch_size=B,
                              lr=3e-4, warmup=2, min_lr=1e-5,
                              weight_decay=0.05, dtype="bfloat16",
                              log_every=1, ckpt_every=6, workdir=work,
                              device="cuda", ema_decay=0.9999,
                              profile_at=profile_at, prefetch=prefetch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary = loop.train(tc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        files = sorted(os.listdir(work)) + sorted(
            os.listdir(os.path.join(work, "profile")))
    return counts, recs, summary, peak, wall, files


def phase_train_vit(smi, steps=12, B=64):
    """ViT-B/16 (87,335,656 parameters) at full width and depth, fp32
    masters and bf16 compute, B=64, on synthetic-imagenet (224x224, 1000
    classes, uint8 normalised on the device) through train/loop.train with
    AdamW, wd 0.05 (bench.py's), cosine lr 3e-4, warmup 2; the loader
    behind the prefetcher (pinned buffers, side-stream copies), its crop and
    flip in the native imagepipe (which must have loaded), EMA 0.9999, an
    async checkpoint at step 6 and a Chrome trace of step 8.  The dataset
    is cut to 64 images a split, one batch an epoch, so each step trains
    on the same images (cropped and flipped anew), as bench.py's row trains
    on one fixed batch: with about one image a class, fresh batches give
    12 steps nothing to learn.  Finite, falling loss; launches 12 K1-fwd,
    12 K2 and 1 K7 a step and no K5, K6 or K8 (the end-of-run evaluation,
    on the EMA weights, adds 12 K1-fwd a batch); step ms (median of steps
    3-12, the traced step left out), images/s, MFU, peak memory, the
    loader's host ms a batch, the step's wait for it, the traced step's
    device busy time over the median step; then the same run with the
    prefetcher off (the loader in the step's thread), for the busy share
    beside it."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data import augment as A
    cfg = get_config("vit-b-16")
    check(P.num_parameters(cfg) == VIT_B16_PARAMS, "vit-b-16 parameter count")
    check(A.native_available(), "[train-vit] the native imagepipe did not "
          "load: " + __import__("vitrs_tpu_torch.native.build",
                                fromlist=["ERRORS"]).ERRORS.get("imagepipe",
                                                                "?"))
    L, eval_batches = cfg.num_layers, 1
    out = {}
    for prefetch in (2, 0):
        counts, recs, summary, peak, wall, files = _vit_run(steps, B,
                                                            prefetch)
        want = designed(flash_fwd=L * (steps + eval_batches),
                        flash_bwd=L * steps, adamw=steps,
                        gelu_fwd=L * (steps + eval_batches),
                        gelu_bwd=L * steps)
        check(counts == want, f"[train-vit] launches {counts} != designed "
              f"{want}")
        losses = [r["loss"] for r in recs]
        check(len(losses) == steps and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"[train-vit] losses {losses}")
        check({"ckpt_00000006.bin", "ema_00000006.tree", "ckpt_00000012.bin",
               "ema_00000012.tree", "trace_step00000008.json"} <= set(files),
              f"[train-vit] files written: {files}")
        steady = [r for r in recs[2:] if r["step"] != 8]
        ips = float(np.median([r["imgs_per_sec"] for r in steady]))
        step_ms = B / ips * 1e3
        prof = summary["profile"]
        r = dict(step_ms=step_ms, imgs_s=ips,
                 mfu=float(np.median([r["mfu"] for r in steady])),
                 loader_ms=float(np.median([r["loader_ms"] for r in steady])),
                 wait_ms=float(np.median([r["wait_ms"] for r in steady])),
                 busy_ms=prof["busy_ms"], busy_share=prof["busy_ms"] / step_ms,
                 groups=prof["groups"], peak_gib=peak / 2**30, losses=losses,
                 eval=summary["eval"], wall_s=wall)
        out[prefetch] = (counts, r)
        ev = summary["eval"]
        print(f"[train-vit] vit-b-16 ({VIT_B16_PARAMS} params) bf16/fp32-"
              f"master B={B} T=197 prefetch={prefetch} native imagepipe, EMA "
              f"0.9999, async ckpt at 6, trace at 8: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; eval (EMA weights) top-1 {ev['acc']:.4f} "
              f"loss {ev['loss']:.4f} on {ev['n']}")
        print(f"[train-vit] prefetch={prefetch} losses {losses}")
        print(f"[train-vit] prefetch={prefetch} steady (median of steps "
              f"3-{steps} but 8): {step_ms:.2f} ms/step, {ips:.1f} images/s, "
              f"MFU {r['mfu']:.4f}; loader {r['loader_ms']:.3f} ms a batch "
              f"on the host, wait {r['wait_ms']:.3f} ms; traced step device "
              f"busy {r['busy_ms']:.3f} ms = {r['busy_share']:.4f} of the "
              f"step; max_memory_allocated {r['peak_gib']:.3f} GiB; wall "
              f"{wall:.1f} s  ({smi})")
        print(f"[train-vit] prefetch={prefetch} traced step groups "
              f"{json.dumps(prof['groups'])}")
    check(out[2][1]["losses"] == out[0][1]["losses"],
          "[train-vit] losses differ with the prefetcher on and off")
    print(f"[train-vit] losses equal with the prefetcher on and off; step "
          f"{out[2][1]['step_ms']:.2f} ms (prefetch) vs "
          f"{out[0][1]['step_ms']:.2f} (none)")
    counts, res = out[2]
    res["no_prefetch"] = out[0][1]
    return counts, res


VSHARD_N, VSHARD_PER = 4, 128   # train-vit-stream's synthetic shards


def jpeg_ready():
    """(whether the native jpegpipe built, the compiler's reason if not)."""
    from vitrs_tpu_torch.data import imagenet as IN
    from vitrs_tpu_torch.native import build
    return IN.native_available(), build.ERRORS.get("jpegpipe", "")


def stream_decoder():
    """(the decoder train-vit-stream runs with, why not the native one):
    "native" where jpegpipe built, else "pil" (the loader's fallback)
    where PIL imports, else None, with both reasons (the synthetic shards
    need PIL to encode, too)."""
    jpeg, why = jpeg_ready()
    if jpeg:
        return "native", ""
    why = "native jpegpipe did not build: " + " | ".join(why.splitlines()[:3])
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        return None, f"{why}; PIL does not import: {e}"
    return "pil", why


def phase_train_vit_stream(smi, decoder, steps=12, B=64):
    """ViT-B/16 at B=64 on streaming ImageNet shards: 4 synthetic JPEG
    shards of 128 images (256x256, 1000 classes, data/imagenet.py's
    build_synthetic_shards) and a val shard, made here; dataset="imagenet"
    through train/loop.train with RandAugment (ra_ops 2, ra_mag 0.5), the
    `decoder` the loader must report (native where jpegpipe built, else
    PIL's), 12 steps; then evaluate_streaming over the val split.  Finite
    loss; launches as train-vit; the decoder, its host ms a batch, the
    wait."""
    from vitrs_tpu_torch.data import imagenet as IN
    from vitrs_tpu_torch.train import loop
    with tempfile.TemporaryDirectory() as work:
        shards = os.path.join(work, "shards")
        t0 = time.perf_counter()
        IN.build_synthetic_shards(shards, n_shards=VSHARD_N,
                                  per_shard=VSHARD_PER, img_size=256,
                                  num_classes=1000, seed=0)
        IN.build_synthetic_shards(shards, n_shards=1, per_shard=VSHARD_PER,
                                  img_size=256, num_classes=1000, seed=9,
                                  split="val")
        made = time.perf_counter() - t0
        tc = loop.TrainConfig(preset="vit-b-16", dataset="imagenet",
                              data_dir=shards, steps=steps, batch_size=B,
                              lr=3e-4, warmup=2, min_lr=1e-5,
                              weight_decay=0.05, dtype="bfloat16",
                              log_every=1, ckpt_every=0,
                              workdir=os.path.join(work, "run"),
                              device="cuda", ra_ops=2, ra_mag=0.5)
        reset_counts()
        summary = loop.train(tc)
        torch.cuda.synchronize()
        counts = read_counts()
        with open(os.path.join(work, "run", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    L = 12
    evb = VSHARD_PER // B
    check(counts == designed(flash_fwd=L * (steps + evb), flash_bwd=L * steps,
                             adamw=steps, gelu_fwd=L * (steps + evb),
                             gelu_bwd=L * steps),
          f"[train-vit-stream] launches {counts}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"[train-vit-stream] losses {losses}")
    check({r["decoder"] for r in recs} == {decoder},
          f"[train-vit-stream] decoders {[r['decoder'] for r in recs]}, "
          f"expected {decoder}")
    ev = summary["eval"]
    check(ev["n"] == evb * B, f"[train-vit-stream] eval {ev}")
    steady = recs[2:]
    res = dict(decoder=decoder,
               loader_ms=float(np.median([r["loader_ms"] for r in steady])),
               wait_ms=float(np.median([r["wait_ms"] for r in steady])),
               step_ms=B / float(np.median([r["imgs_per_sec"]
                                            for r in steady])) * 1e3,
               losses=losses, eval=ev, shards_s=made)
    print(f"[train-vit-stream] vit-b-16 B={B} on {VSHARD_N} x {VSHARD_PER} "
          f"synthetic JPEG shards (made in {made:.1f} s), RandAugment 2 @ "
          f"0.5, decoder {decoder}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {decoder} decode {res['loader_ms']:.3f} ms a "
          f"batch, wait "
          f"{res['wait_ms']:.3f} ms, {res['step_ms']:.2f} ms/step; "
          f"evaluate_streaming top-1 {ev['acc']:.4f} on {ev['n']}  ({smi})")
    return counts, res


def phase_resume(smi, steps=12, B=8):
    """GPT-2 124M, B=8, T=1024, AdamW, with the prefetcher and async
    checkpoints on: 12 steps straight (checkpoints at 6 and 12) against 6
    steps (run_steps), then a resume for 6 more.  The logged losses, the
    final loss and the step-12 checkpoint (params, m, v, cursor) must be
    equal bit for bit: K2 is deterministic, so a difference points at the
    cursor, the prefetcher or the snapshot."""
    from vitrs_tpu_torch.train import loop
    with tempfile.TemporaryDirectory() as work:
        def run(workdir, **kw):
            tc = loop.TrainConfig(preset="gpt2-124m", dataset="", steps=steps,
                                  batch_size=B, lr=6e-4, warmup=2,
                                  min_lr=6e-5, weight_decay=0.1,
                                  dtype="bfloat16", log_every=1, ckpt_every=6,
                                  workdir=os.path.join(work, workdir),
                                  device="cuda", **kw)
            return loop.train(tc)

        reset_counts()
        straight = run("straight")
        counts = read_counts()
        first = run("resumed", run_steps=steps // 2)
        second = run("resumed")
        logs, ckpts = {}, {}
        for name in ("straight", "resumed"):
            with open(os.path.join(work, name, "metrics.jsonl")) as f:
                logs[name] = [json.loads(line)["loss"] for line in f]
            with open(os.path.join(work, name, f"ckpt_{steps:08d}.bin"),
                      "rb") as f:
                ckpts[name] = f.read()
    check(counts == designed(flash_fwd=12 * steps, flash_bwd=12 * steps,
                             ce_fwd=steps, ce_bwd=steps, adamw=steps,
                             gelu_fwd=12 * steps, gelu_bwd=12 * steps),
          f"[resume] launches {counts}")
    check(logs["straight"] == logs["resumed"] and len(logs["straight"]) == steps,
          f"[resume] losses {logs['straight']} vs {logs['resumed']}")
    check(straight["final_loss"] == second["final_loss"],
          f"[resume] final loss {straight['final_loss']!r} vs "
          f"{second['final_loss']!r}")
    check(ckpts["straight"] == ckpts["resumed"],
          "[resume] the step-12 checkpoints differ")
    print(f"[resume] gpt2-124m B={B} T=1024, prefetch + async ckpt: 12 "
          f"straight == 6 (run_steps) + resume 6: losses {logs['straight']}, "
          f"final loss {second['final_loss']!r} bit for bit (after 6: "
          f"{first['final_loss']!r}); step-12 checkpoints byte-identical "
          f"({len(ckpts['straight'])} bytes)  ({smi})")
    return dict(losses=logs["straight"], final_loss=second["final_loss"],
                ckpt_bytes=len(ckpts["straight"]))


# --------------------------------------------------------------------------
# The rest of serving: the paged engine, the int8 KV cache and int8
# weights, beam search, speculative decoding, the int8 ViT forwards
# --------------------------------------------------------------------------

SERVE_LENGTHS = (5, 37, 128, 300, 511, 700, 900, 960)     # phase serve's
WAVE2_LENGTHS = (16, 64, 200, 333, 450, 600, 800, 990)


def _gpt2_124m(seed=0):
    """gpt2-124m in bf16 from seeded random weights: (cfg, prepared
    params on the card)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt2-124m", dtype="bfloat16")
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    return cfg, M.prepare_params(params, cfg)


def _engine_run(params, cfg, prompts, max_new=32, **kw):
    """A GenerationEngine (8 slots, max_len 1024, buckets 128/512/1024)
    over `prompts`: (engine, streams {rid: tokens}, wall s, peak bytes,
    launch counts, the prefill groups as (K_pad, rids))."""
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    eng = GenerationEngine(params, cfg, max_slots=8, max_len=1024,
                           prompt_buckets=(128, 512, 1024), **kw)
    rids = {}
    for p in prompts:
        rids[eng.submit(p, max_new=max_new)] = p
    groups = []
    plain = {n: getattr(G, n) for n in ("prefill_into_slots",
                                         "prefill_into_pages_multi")}

    def recorder(fn):
        def recording(prm, prompts_, *a, **k):
            rows = prompts_.cpu().numpy()
            groups.append((rows.shape[0], sorted(
                {r for r, p in rids.items()
                 for row in rows if np.array_equal(row[:len(p)], p)
                 and not row[len(p):].any()})))
            return fn(prm, prompts_, *a, **k)
        return recording

    for name, fn in plain.items():
        setattr(G, name, recorder(fn))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        outs = dict(eng.run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in plain.items():
            setattr(G, name, fn)
    return (eng, outs, wall, torch.cuda.max_memory_allocated(), read_counts(),
            groups)


def phase_serve_paged(smi):
    """gpt2-124m (bf16, seeded random weights) through the paged engine:
    8 slots, max_len 1024, buckets 128/512/1024, a pool of 257 pages (the
    sink + 256: half the dense-equivalent 513), so admission waits for
    pages and pages are reused; phase serve's 8 prompts, then a second
    wave of 8, 32 greedy tokens each, at decode_chunk 1 and 16.
    K1-fwd launches == 12 x prefill groups; every non-sink page returns to
    the pool.  The streams equal the dense engine's: a request's stream
    depends on the row count of the prefill it shared (cuBLAS picks its
    GEMM by the rows) and on nothing else, since decode runs all 8 slots
    over 1024 positions in both engines, so each paged prefill group is
    served again by the dense engine as a group of the same size, and the
    streams must match token for token.  The dense engine's run of all 16
    requests is timed beside (its groups differ: slots, not pages, bound
    them), with its share of equal streams.  Prints tok/s, the pool's bytes
    against the dense cache's and the peak memory of both."""
    cfg, pp = _gpt2_124m()
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    prompts = ([rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENGTHS]
               + [rng.integers(0, cfg.vocab_size, n) for n in WAVE2_LENGTHS])
    n_pages = 257
    _engine_run(pp, cfg, prompts[:4], decode_chunk=16, paged=True,
                n_pages=n_pages)                  # warm-up
    dense_eng, dense, dense_wall, dense_peak, _, _ = _engine_run(
        pp, cfg, prompts, decode_chunk=16)
    res = dict(dense_tok_s=16 * 32 / dense_wall,
               dense_peak_gib=dense_peak / 2**30,
               dense_cache_bytes=sum(c.numel() * c.element_size()
                                     for c in dense_eng.caches))
    ref = {}                    # (K_pad, rids) -> the dense engine's streams
    for chunk in (1, 16):
        eng, outs, wall, peak, counts, groups = _engine_run(
            pp, cfg, prompts, decode_chunk=chunk, paged=True, n_pages=n_pages)
        check(counts == designed(flash_fwd=L * eng.prefill_dispatches,
                                 gelu_fwd=L * (eng.prefill_dispatches
                                               + eng.decode_ticks))
              and len(groups) == eng.prefill_dispatches,
              f"[serve-paged] chunk {chunk}: launches {counts}, "
              f"{eng.prefill_dispatches} prefill groups")
        check(sorted(eng.free_pages) == list(range(1, n_pages)),
              f"[serve-paged] chunk {chunk}: pages not returned")
        check(sorted(r for _, rs in groups for r in rs) == list(range(16)),
              f"[serve-paged] groups {groups}")
        for k_pad, rs in groups:
            if (k_pad, tuple(rs)) not in ref:
                _, got, *_ = _engine_run(pp, cfg, [prompts[r] for r in rs],
                                         decode_chunk=16)
                ref[(k_pad, tuple(rs))] = {r: got[i] for i, r in
                                           enumerate(rs)}
            for r in rs:
                check(np.array_equal(outs[r], ref[(k_pad, tuple(rs))][r]),
                      f"[serve-paged] chunk {chunk} request {r}: the paged "
                      f"stream differs from the dense engine's")
        for r, p in enumerate(prompts):
            gen = outs[r][len(p):]
            check(len(outs[r]) == len(p) + 32 and bool(
                ((gen >= 0) & (gen < cfg.vocab_size)).all()),
                f"[serve-paged] request {r}")
        same = sum(np.array_equal(outs[r], dense[r]) for r in range(16))
        pool = sum(c.numel() * c.element_size() for c in eng.caches)
        res[chunk] = dict(tok_s=16 * 32 / wall, peak_gib=peak / 2**30,
                          pool_bytes=pool, groups=[k for k, _ in groups],
                          launches=counts, equal_to_dense_run=same)
        print(f"[serve-paged] chunk {chunk}: {len(groups)} prefill groups "
              f"(padded sizes {[k for k, _ in groups]}), "
              f"{counts['flash_fwd']} K1-fwd launches; {16 * 32 / wall:.1f} "
              f"tok/s (dense engine {res['dense_tok_s']:.1f}); pool "
              f"{pool / 2**20:.1f} MiB = {pool / res['dense_cache_bytes']:.4f}"
              f" of the dense cache's {res['dense_cache_bytes'] / 2**20:.1f}; "
              f"peak {peak / 2**30:.3f} GiB (dense {dense_peak / 2**30:.3f}); "
              f"streams equal the group-matched dense engine's, {same} of 16 "
              f"equal the all-at-once dense run's  ({smi})")
    return res


def phase_serve_int8(smi):
    """(a) serve-gqa's model (gpt2-124m, 4 kv heads, max_seq_len 8192,
    bf16), B=8, a 7680-token prompt, greedy, with the int8 KV cache:
    chunked (512: one K3-fwd chunk, then K4 over the cache dequantized to
    the flat layout, 12 + 168 launches) and whole (12 K3-fwd), 1 and 33
    new tokens, beside the bf16 cache; logits within 5e-2 of their largest
    value from the bf16 cache's, at the chunked prefill's last position
    and at 4 decode steps after each prefill; the int8 cache's bytes under
    0.6 of bf16's.  (b) gpt2-124m with weight-only int8 params
    (ops/quant.quantize_params) through the dense engine: phase serve's 8
    requests, finite streams, the share of tokens equal to the bf16
    engine's, tok/s of both."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops import quant as QT
    cfg = get_config("gpt2-124m", num_kv_heads=4, max_seq_len=8192,
                     dtype="bfloat16")
    pp = M.prepare_params(P.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    B, T0, L = 8, 7680, cfg.num_layers
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def run(chunk, max_new, int8):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(pp, prompt, cfg, max_new, temperature=0.0,
                         prefill_chunk=chunk, kv_int8=int8)
        torch.cuda.synchronize()
        gen = out[:, T0:]
        check(out.shape == (B, T0 + max_new) and bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all()), "[serve-int8] ids")
        return (time.perf_counter() - t0) * 1e3, read_counts()

    run(512, 2, True)                          # warm-up
    res = {}
    for int8 in (True, False):
        for chunk in (512, 0):
            ms1, c1 = run(chunk, 1, int8)
            msn, cn = run(chunk, 33, int8)
            chunks = T0 // chunk if chunk else 1
            want = designed(flash_gqa_fwd=L, flash_prefill=L * (chunks - 1),
                            gelu_fwd=L * chunks)
            wantn = dict(want, gelu_fwd=L * (chunks + 32))
            check(c1 == want and cn == wantn, f"[serve-int8] int8 {int8} "
                  f"chunk {chunk}: launches {c1} / {cn} != {want} / {wantn}")
            key = f"{'int8' if int8 else 'bf16'}_{chunk}"
            res[key] = dict(prefill_ms=ms1, ms_per_new_token=(msn - ms1) / 32,
                            launches=c1)
            print(f"[serve-int8] {key.replace('_', ' cache, chunk ')}: "
                  f"launches flash_gqa_fwd {c1['flash_gqa_fwd']}, "
                  f"flash_prefill {c1['flash_prefill']}; prefill "
                  f"{ms1:.2f} ms; {(msn - ms1) / 32:.3f} ms per new token  "
                  f"({smi})")
    # logits over the int8 cache against the bf16 cache's on the same
    # tokens: the chunked prefill's last position (K4 over the dequantized
    # cache), then DECODE steps of fixed tokens after the chunked and after
    # the whole prefill (one token each, dense over the dequantized
    # cache).  The whole prefill's own logits are left out: its prompt
    # attends the exact k/v, so there both caches compute the same thing.
    DECODE = 4
    steps = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, DECODE)), device="cuda")
    errs = {}
    for chunk in (512, 0):
        lg = {}
        for int8 in (True, False):
            caches = G.init_kv_cache(cfg, B, 7936, int8=int8, device="cuda")
            step = chunk or T0
            for off in range(0, T0, step):
                logits, caches = G.forward_with_cache(
                    pp, prompt[:, off:off + step], caches, off, cfg,
                    last_only=True)
            got = [logits[:, -1].float()]
            for j in range(DECODE):
                logits, caches = G.forward_with_cache(
                    pp, steps[:, j:j + 1], caches, T0 + j, cfg)
                got.append(logits[:, -1].float())
            lg[int8] = torch.stack(got, dim=1)         # (B, 1 + DECODE, V)
        check(bool(torch.isfinite(lg[True]).all()), "[serve-int8] logits")
        rel = ((lg[True] - lg[False]).abs().amax(dim=(0, 2))
               / lg[False].abs().amax(dim=(0, 2))).tolist()
        if chunk:
            errs["chunked_prefill"] = rel[0]
        errs[f"decode_after_{'chunked' if chunk else 'whole'}"] = max(rel[1:])
    qbytes = sum(t.numel() * t.element_size() for pair in
                 G.init_kv_cache(cfg, B, 7936, int8=True, device="cuda")
                 for t in pair)
    fbytes = sum(t.numel() * t.element_size() for t in
                 G.init_kv_cache(cfg, B, 7936, device="cuda"))
    print(f"[serve-int8] logits, int8 vs bf16 cache, of their largest: "
          f"chunked prefill's last position {errs['chunked_prefill']:.4e}; "
          f"worst of {DECODE} decode steps after the chunked prefill "
          f"{errs['decode_after_chunked']:.4e}, after the whole prefill "
          f"{errs['decode_after_whole']:.4e}; cache bytes {qbytes} vs "
          f"{fbytes} = {qbytes / fbytes:.4f}")
    check(max(errs.values()) <= 5e-2,
          f"[serve-int8] int8 cache logits off by {errs}")
    check(qbytes < 0.6 * fbytes, f"[serve-int8] cache bytes {qbytes / fbytes}")
    res.update(logits_err=errs, cache_bytes_ratio=qbytes / fbytes)
    del pp, prompt

    cfg, pp = _gpt2_124m()
    qp = M.prepare_params(QT.quantize_params(
        P.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
        mode="gpt"), cfg)
    check("head" not in qp and qp["fcw"].dtype == torch.int8, "int8 params")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENGTHS]
    _engine_run(qp, cfg, prompts[:2], decode_chunk=16)      # warm-up
    runs = {}
    for name, prm in (("w8", qp), ("bf16", pp)):
        eng, outs, wall, peak, counts, _ = _engine_run(prm, cfg, prompts,
                                                       decode_chunk=16)
        check(counts == designed(flash_fwd=L * eng.prefill_dispatches,
                                 gelu_fwd=L * (eng.prefill_dispatches
                                               + eng.decode_ticks)),
              f"[serve-int8] {name} engine launches {counts}")
        runs[name] = (outs, 8 * 32 / wall, peak, counts)
    gen = {k: np.stack([v[0][i][n:] for i, n in enumerate(SERVE_LENGTHS)])
           for k, v in runs.items()}
    check(bool(((gen["w8"] >= 0) & (gen["w8"] < cfg.vocab_size)).all()),
          "[serve-int8] w8 ids")
    share = float((gen["w8"] == gen["bf16"]).mean())
    res["w8_engine"] = dict(tok_s=runs["w8"][1], bf16_tok_s=runs["bf16"][1],
                            equal_share=share,
                            peak_gib=runs["w8"][2] / 2**30,
                            bf16_peak_gib=runs["bf16"][2] / 2**30,
                            launches=runs["w8"][3])
    print(f"[serve-int8] gpt2-124m w8 engine, 8 requests x 32: "
          f"{runs['w8'][1]:.1f} tok/s (bf16 {runs['bf16'][1]:.1f}); "
          f"{share:.4f} of the tokens equal the bf16 engine's; peak "
          f"{runs['w8'][2] / 2**30:.3f} GiB (bf16 {runs['bf16'][2] / 2**30:.3f})"
          f"  ({smi})")
    return res


def _logprob(p32, cfg32, seqs, T0):
    """fp32 teacher-forced log-prob of seqs[:, T0:] given their prefix."""
    from vitrs_tpu_torch.models import model as M
    lg = M.gpt_forward(p32, seqs[:, :-1], cfg32).float()
    lp = torch.log_softmax(lg, dim=-1).gather(-1, seqs[:, 1:, None])[..., 0]
    return lp[:, T0 - 1:].sum(-1)


def phase_serve_beam(smi):
    """gpt2-124m (bf16, seeded random weights), B=4, a 128-token prompt,
    32 new tokens: `generate_beam` at beams 4 and 1 (one prefill: 12 K1-fwd
    launches a call); beams=1 equals greedy `generate`; each row's best
    beam scores at least greedy's fp32 teacher-forced log-prob (the fp32
    model on the same weights); ms a call beside greedy."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg, pp = _gpt2_124m()
    L = cfg.num_layers
    B, T0, N = 4, 128, 32
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, read_counts()

    G.generate_beam(pp, prompt, cfg, 2, beams=4)          # warm-up
    greedy, g_ms, gc = timed(lambda: G.generate(pp, prompt, cfg, N,
                                                temperature=0.0))
    one, one_ms, oc = timed(lambda: G.generate_beam(pp, prompt, cfg, N,
                                                    beams=1))
    beam, b_ms, bc = timed(lambda: G.generate_beam(pp, prompt, cfg, N,
                                                   beams=4))
    for c in (gc, oc, bc):
        check(c == designed(flash_fwd=L, gelu_fwd=L * N),
              f"[serve-beam] launches {c}")
    check(torch.equal(one, greedy), "[serve-beam] beams=1 != greedy")
    check(beam.shape == (B, T0 + N) and torch.equal(beam[:, :T0], prompt),
          "[serve-beam] shape")
    cfg32 = cfg.replace(dtype="float32")
    p32 = M.prepare_params(P.init_params(
        cfg32, torch.Generator(device="cuda").manual_seed(0)), cfg32)
    lp_b, lp_g = (_logprob(p32, cfg32, s, T0) for s in (beam, greedy))
    print(f"[serve-beam] gpt2-124m B={B} T0={T0} +{N}: beams 4 {b_ms:.1f} ms, "
          f"beams 1 {one_ms:.1f} ms (== greedy, {g_ms:.1f} ms); {L} K1-fwd "
          f"launches a call; fp32 log-prob best beam {lp_b.tolist()} vs "
          f"greedy {lp_g.tolist()}  ({smi})")
    check(bool((lp_b >= lp_g).all()),
          "[serve-beam] a best beam scores below greedy")
    return dict(beam_ms=b_ms, greedy_ms=g_ms, beam1_ms=one_ms,
                launches=bc, logprob_beam=lp_b.tolist(),
                logprob_greedy=lp_g.tolist())


def phase_serve_spec(smi):
    """Speculative decoding (models/speculative.py): target gpt2-350m,
    draft gpt2-124m (bf16, seeded random weights), B=1, a 128-token
    prompt, 128 new tokens, K=4; then a self-draft (the target drafts for
    itself).  Launches: the two prefills' K1-fwd (24 + 12, or 24 + 24);
    the verify chunks run dense (the cache, 128 + 128 + 5, is no multiple
    of 256).  Prints target_calls, drafted, accepted and ms per token
    beside target-only greedy `generate`, and the first token that differs
    from it with the target's logit gap there (bf16 near-ties flip between
    the batched verify and stepwise decode: reported, not required
    equal)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.models import speculative as S
    tcfg = get_config("gpt2-350m", dtype="bfloat16")
    tp = M.prepare_params(P.init_params(
        tcfg, torch.Generator(device="cuda").manual_seed(0)), tcfg)
    dcfg, dp = _gpt2_124m(seed=1)
    T0, N, K = 128, 128, 4
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, T0)), device="cuda")
    S.generate_speculative(tp, dp, prompt, tcfg, dcfg, 8, K)    # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = G.generate(tp, prompt, tcfg, N, temperature=0.0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(read_counts() == designed(flash_fwd=tcfg.num_layers,
                                    gelu_fwd=tcfg.num_layers * N),
          "[serve-spec] generate launches")
    res = dict(plain_ms_per_token=plain_ms / N)
    for name, d, dc in (("draft", dp, dcfg), ("self", tp, tcfg)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = S.generate_speculative(tp, d, prompt, tcfg, dc, N, K)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        # GELU: both prefills, then a round's K draft steps and one verify
        calls = stats["target_calls"]
        check(counts == designed(
            flash_fwd=tcfg.num_layers + dc.num_layers,
            gelu_fwd=tcfg.num_layers * (1 + calls)
            + dc.num_layers * (1 + K * calls)),
              f"[serve-spec] {name}: launches {counts}")
        check(out.shape == (1, T0 + N) and torch.equal(out[:, :T0], prompt)
              and bool(((out >= 0) & (out < tcfg.vocab_size)).all()),
              f"[serve-spec] {name}: output")
        check(stats["drafted"] == K * stats["target_calls"]
              and 0 <= stats["accepted"] <= stats["drafted"],
              f"[serve-spec] {name}: stats {stats}")
        diff = (out[0] != want[0]).nonzero()
        first, gap = None, None
        if len(diff):
            first = int(diff[0])
            lg = M.gpt_forward(tp, out[:, :first], tcfg)[0, -1].float()
            gap = (lg[want[0, first]] - lg[out[0, first]]).item()
        res[name] = dict(ms_per_token=ms / N, launches=counts,
                         first_diff=first, logit_gap=gap, **stats)
        print(f"[serve-spec] gpt2-350m with {name} draft, K={K}, B=1, "
              f"T0={T0} +{N}: target_calls {stats['target_calls']}, drafted "
              f"{stats['drafted']}, accepted {stats['accepted']}; "
              f"{ms / N:.3f} ms per token (target-only generate "
              f"{plain_ms / N:.3f}); first token unlike target-only greedy: "
              f"{'none' if first is None else first - T0} (target logit gap "
              f"{gap})  ({smi})")
    return res


def phase_infer_vit_quant(smi, steps=10):
    """vit-s-16 and vit-b-16 (bf16, seeded random weights) at B=256
    through the infer CLI's function with quant none, w8 and w8a8 (w8a8's
    products on the int8 tensor cores, `torch._int_mm`): 12 K1-fwd and
    12 GELU launches a forward and no other kernel; the int8 logits track the bf16
    forward's within the JAX package's bounds (tests/test_quant.py: mean
    relative 0.04 w8, 0.08 w8a8); images/s, latency, peak memory."""
    from vitrs_tpu_torch.cli import infer
    from vitrs_tpu_torch.config import get_config
    res = {}
    for preset in ("vit-s-16", "vit-b-16"):
        ref = None
        for quant in ("none", "w8", "w8a8"):
            reset_counts()
            rec = infer.run(preset, batch_size=256, steps=steps,
                            dtype="bfloat16", device="cuda", quant=quant)
            torch.cuda.synchronize()
            counts = read_counts()
            logits = rec.pop("logits").float()
            L = get_config(preset).num_layers
            check(counts == designed(flash_fwd=L * (steps + 1),
                                     gelu_fwd=L * (steps + 1)),
                  f"[infer-vit-quant] {preset} {quant}: launches {counts}")
            check(tuple(logits.shape) == (256, 1000)
                  and bool(torch.isfinite(logits).all()),
                  f"[infer-vit-quant] {preset} {quant}: logits")
            if ref is None:
                ref, rel = logits, 0.0
            else:
                rel = ((logits - ref).abs().mean() / ref.abs().mean()).item()
            bound = {"none": 0.0, "w8": 0.04, "w8a8": 0.08}[quant]
            check(rel <= bound, f"[infer-vit-quant] {preset} {quant}: mean "
                  f"relative {rel} vs bf16")
            res[f"{preset} {quant}"] = dict(
                images_s=rec["value"], latency_ms=rec["latency_ms"],
                peak_gib=rec["peak_mem_gib"], rel_err=rel, launches=counts)
            print(f"[infer-vit-quant] {preset} {quant} B=256: "
                  f"{rec['value']} images/s, latency {rec['latency_ms']} ms, "
                  f"peak {rec['peak_mem_gib']} GiB; logits vs bf16 mean "
                  f"relative {rel:.4e}; {counts['flash_fwd'] // (steps + 1)} "
                  f"K1-fwd launches a forward  ({smi})")
    return res


# ---------------------------------------------------------------------------
# the reference-exact path and the model families
# ---------------------------------------------------------------------------

# (B, T, NH) of the families' attention: the MAE encoder on ViT-B/16 (1 + 49
# kept patches), its decoder (512 wide, 8 heads, 196 + 1 tokens) at
# pretrain-mae's B=64, and the CLIP-L/14 tower (256 + 1 tokens, 16 heads)
# at train-clip's B=64
FAMILY_SHAPES = {"mae_enc": (64, 50, 12), "mae_dec": (64, 197, 8),
                 "clip": (64, 257, 16)}
CLIP_L14_PARAMS = 304_752_384
FAMILY_CAPTURES = 10
LORA_PARAMS = 1_179_648          # rank 8 on qkv/attproj/fc/fcproj, 12 layers


def phase_kernels_families():
    """K1-fwd and K2 at causal=False at FAMILY_SHAPES against their plain
    versions, bf16 and fp32, to kernels-vit's tolerances (out as
    `out_errors`, lse 1e-4 / 1e-5, dq/dk/dv 2e-2 / 1e-4 abs + rel); two
    calls of each give the same bits.  Then in bf16: kernel and plain by
    events (plain, kernel, kernel, plain), the kernel's device time by the
    profiler (`device_ms`, up to FAMILY_CAPTURES captures: at T=50 the
    kernels take a few microseconds, and a whole smoke run has seen three
    captures in a row miss K2's), SDPA's non-causal forward and backward
    on the same tensors (by events, and the largest of three device
    readings), and the bound (`fwd_bound` / `bwd_bound`)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(12)
    res = {}
    for tag, (B, T, nh) in FAMILY_SHAPES.items():
        Cv = nh * D
        worst = {"fwd": 0.0, "bwd": 0.0}
        for dtype, lse_tol, tol in ((torch.bfloat16, 1e-4, 2e-2),
                                    (torch.float32, 1e-5, 1e-4)):
            qkv = torch.randn(B, T, 3 * Cv, generator=gen,
                              device="cuda").to(dtype)
            do = torch.randn(B, T, Cv, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(Cv, dim=-1)
            where = f"{tag} B={B} T={T} NH={nh} {str(dtype)[6:]}"
            (out, lse), (out2, lse2) = (FA.flash_fwd_cuda(q, k, v, nh, False,
                                                          0.125)
                                        for _ in range(2))
            ref, ref_lse = FA.flash_fwd_plain(q, k, v, nh, False, 0.125)
            got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, False,
                                            0.125) for _ in range(2))
            want = FA.flash_bwd_plain(q, k, v, out, lse, do, nh, False, 0.125)
            torch.cuda.synchronize()
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"K1-fwd {where}: two calls differ")
            bad, err, rms = out_errors(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            check(bad == 0, f"K1-fwd {where}: {bad} out values beyond "
                  f"tolerance")
            check(lse_err <= lse_tol, f"K1-fwd {where}: lse err {lse_err}")
            errs = []
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(a, b), f"K2 {where}: {name} differs between "
                      f"two calls")
                d = (a.float() - c.float()).abs()
                nbad = ((d > tol + tol * c.float().abs()).sum().item()
                        + (~torch.isfinite(a)).sum().item())
                check(nbad == 0, f"K2 {where}: {nbad} {name} values beyond "
                      f"{tol}")
                errs.append(d.max().item())
            print(f"[kernels-families] {where} causal=0: out max_abs_err "
                  f"{err:.3e} (rms {rms:.3e}), lse {lse_err:.3e}; dq/dk/dv "
                  f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}; each bitwise "
                  f"equal over two calls")
            if dtype == torch.bfloat16:
                worst = {"fwd": err, "bwd": max(errs)}
            del qkv, do, q, k, v, out, out2, ref, got, again, want
        qkv = torch.randn(B, T, 3 * Cv, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, T, Cv, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.split(Cv, dim=-1)
        out, lse = FA.flash_fwd_cuda(q, k, v, nh, False, 0.125)
        shape = f"bf16 B={B} T={T} NH={nh} D=64 non-causal"
        parts = {
            "fwd": (lambda: FA.flash_fwd_cuda(q, k, v, nh, False, 0.125),
                    lambda: FA.flash_fwd_plain(q, k, v, nh, False, 0.125),
                    lambda: sdpa(q, k, v, nh, nh, causal=False), 2, 1),
            "bwd": (lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, nh,
                                              False, 0.125),
                    lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, nh,
                                               False, 0.125),
                    sdpa_bwd(q, k, v, do, nh, nh, causal=False), 5, 3)}
        for part, (kern, plain, lib_fn, passes, n_kern) in parts.items():
            km, pm, raw = timed_pair(kern, plain)
            dev, caps = device_ms(kern, n_kern, captures=FAMILY_CAPTURES)
            # SDPA's kernel count is its own: a capture that drops some of
            # them reads low, so the largest of three readings is kept
            lib_reads = [device_ms(lib_fn) for _ in range(3)]
            lib_dev = max((d for d, _ in lib_reads if d), default=None)
            lib_caps = sum(c for _, c in lib_reads)
            lib = cuda_ms(lib_fn)
            flops, (bms, by) = (
                fwd_bound(B, nh, nh, D, T, 0, T, 2, causal=False)
                if passes == 2 else
                bwd_bound(B, nh, nh, D, T, 2, causal=False))
            name = "K1-fwd" if part == "fwd" else "K2"
            check(dev is not None, f"{name} {shape}: none of "
                  f"{FAMILY_CAPTURES} traces caught its kernels")
            print(f"[kernels-families] {name} time {tag} {shape}: kernel "
                  f"{raw[0]:.4f}/{raw[1]:.4f} ms by events, {dev:.4f} ms "
                  f"device ({flops / dev / 1e9:.1f} TFLOP/s, {bms / dev:.3f} "
                  f"of the bound; capture {caps}); plain {raw[2]:.4f}/"
                  f"{raw[3]:.4f} ms; SDPA {lib:.4f} ms by events, "
                  f"{lib_dev or 'not captured'} device (capture {lib_caps}); "
                  f"bound {bms:.4f} ms ({by})")
            res.setdefault(part, {})[tag] = dict(
                max_abs_err=worst[part], ms=km, device_ms=dev,
                device_captures=caps, plain_ms=pm, library_ms=lib,
                library_device_ms=lib_dev, library_device_captures=lib_caps,
                bound_ms=bms, bound_by=by,
                share_of_bound=bms / dev, tflops_device=flops / dev / 1e9,
                shape=shape)
        del qkv, do, q, k, v, out, lse
    return res


def _busy_share(profile, step_ms):
    return profile["busy_ms"] / step_ms if profile.get("busy_ms") else None


def phase_pretrain_mae(smi, steps=12, B=64):
    """vitrs-pretrain-mae-torch's loop (cli/pretrain_mae.run) on vit-b-16 at
    full width (encoder 768 x 12, decoder 512 x 4, 75% masked: the encoder
    sees 1 + 49 tokens, the decoder 197), B=64, synthetic-imagenet
    224 x 224 (64 images, one batch an epoch), AdamW over the {"encoder",
    "decoder"} tree, lr 1.5e-4, warmup 2, a trace of step 8: finite,
    falling loss; 16 K1-fwd and 16 K2 a step (12 encoder + 4 decoder
    layers) and no K5, K6 or K7; step ms (median of steps 3-12 but 8),
    images/s, the traced step's busy share, peak memory.  Then 4 steps of
    train/loop.train warm-started from its encoder_final.bin (--init-ckpt):
    the loaded weights are the encoder's, the loss finite."""
    import argparse
    from vitrs_tpu_torch import checkpoint as C
    from vitrs_tpu_torch.cli import pretrain_mae
    from vitrs_tpu_torch.train import loop
    with tempfile.TemporaryDirectory() as work:
        args = argparse.Namespace(
            preset="vit-b-16", dataset="synthetic-imagenet", data_dir=None,
            dataset_size=B, steps=steps, batch_size=B, lr=1.5e-4, warmup=2,
            weight_decay=0.05, mask_ratio=0.75, seed=0, dtype="bfloat16",
            workdir=os.path.join(work, "mae"), log_every=1, profile_at=8,
            cpu=False)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary = pretrain_mae.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(args.workdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        want = designed(flash_fwd=16 * steps, flash_bwd=16 * steps,
                        gelu_fwd=16 * steps, gelu_bwd=16 * steps)
        check(counts == want, f"[pretrain-mae] launches {counts} != "
              f"designed {want}")
        losses = summary["losses"]
        check(len(losses) == steps and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"[pretrain-mae] losses {losses}")
        steady = [r for r in recs[2:] if r["step"] != 8]
        ips = float(np.median([r["imgs_per_sec"] for r in steady]))
        step_ms = B / ips * 1e3
        prof = summary["profile"]
        busy = _busy_share(prof, step_ms)
        enc = summary["params"]["encoder"]
        del summary
        print(f"[pretrain-mae] vit-b-16 MAE (decoder 512 x 4) bf16/fp32-"
              f"master B={B} mask 0.75: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; losses {losses}")
        print(f"[pretrain-mae] launches per step: flash_fwd "
              f"{counts['flash_fwd'] // steps}, flash_bwd "
              f"{counts['flash_bwd'] // steps}, gelu_fwd / gelu_bwd as many, "
              f"every other kernel 0; steady "
              f"(median of steps 3-{steps} but 8): {step_ms:.2f} ms/step, "
              f"{ips:.1f} images/s; traced step busy "
              f"{busy if busy is None else round(busy, 4)} of the step; "
              f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} "
              f"s  ({smi})")
        arrs, cfg, _ = C.load_checkpoint(os.path.join(args.workdir,
                                                      "encoder_final.bin"))
        check(all(np.array_equal(arrs[k], enc[k].float().cpu().numpy())
                  for k in arrs), "[pretrain-mae] encoder_final.bin is not "
              "the trained encoder")
        del enc
        tc = loop.TrainConfig(preset="vit-b-16", dataset="synthetic-imagenet",
                              dataset_size=B, steps=4, batch_size=B, lr=3e-4,
                              warmup=1, dtype="bfloat16", log_every=1,
                              ckpt_every=0, workdir=os.path.join(work, "ft"),
                              device="cuda",
                              init_ckpt=os.path.join(args.workdir,
                                                     "encoder_final.bin"))
        reset_counts()
        ft = loop.train(tc)
        ft_counts = read_counts()
        check(np.isfinite(ft["final_loss"]), f"[pretrain-mae] warm-started "
              f"run's loss {ft['final_loss']}")
        check(ft_counts["adamw"] == 4 and ft_counts["flash_bwd"] == 48,
              f"[pretrain-mae] warm-started run's launches {ft_counts}")
    print(f"[pretrain-mae] 4 steps of vitrs-train-torch --init-ckpt "
          f"encoder_final.bin: final loss {ft['final_loss']:.4f}, eval "
          f"{ft['eval']}")
    return counts, dict(step_ms=step_ms, imgs_s=ips, busy_share=busy,
                        busy_ms=prof["busy_ms"], groups=prof["groups"],
                        peak_gib=peak / 2**30, losses=losses, wall_s=wall,
                        warm_start=dict(final_loss=ft["final_loss"],
                                        eval=ft["eval"]))


def phase_finetune_lora(smi, full_train, steps=12, B=8):
    """vitrs-finetune-torch (cli/finetune.run) on a GPT-2 124M base
    checkpoint of seeded random weights written by the port: rank 8, alpha
    16, B=8, T=1024, bf16 compute, 12 steps, --merge.  1,179,648 adapter
    parameters; a finite loss; 12 K1-fwd, 12 K2, 1 K5, 1 K6 a step and no
    K7 (the held-out evaluation adds K1-fwd and K5 launches); the base
    tensors bit for bit as loaded and without .grad; the adapter file; the
    merged checkpoint reloading to the same logits as apply_lora's.  Step
    ms and peak memory beside the full finetune's (phase train); then one
    more `lora_train_step` under the profiler for its device time and
    busy share."""
    import argparse
    from vitrs_tpu_torch import checkpoint as C
    from vitrs_tpu_torch import checkpoint_tree as CT
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.cli import finetune
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import lora as LO
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.utils import profiling
    cfg = get_config("gpt2-124m")
    with tempfile.TemporaryDirectory() as work:
        base = os.path.join(work, "base.bin")
        params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(3))
        C.save_checkpoint(base, params, cfg)
        del params
        args = argparse.Namespace(
            ckpt=base, data_dir=None, steps=steps, batch_size=B, lr=1e-4,
            warmup=2, rank=8, alpha=16.0, weight_decay=0.0, seed=0,
            log_every=1, dtype="bfloat16", out=os.path.join(work, "a.tree"),
            resume=None, merge=os.path.join(work, "merged.bin"), cpu=False)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s = finetune.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        L = cfg.num_layers
        check(s["adapter_params"] == LORA_PARAMS, f"[finetune-lora] "
              f"{s['adapter_params']} adapter parameters")
        check(counts["flash_bwd"] == L * steps and counts["ce_bwd"] == steps
              and counts["adamw"] == 0 and counts["flash_fwd"] >= L * steps
              and (counts["flash_fwd"] - L * steps) % L == 0
              and counts["ce_fwd"] - steps == (counts["flash_fwd"]
                                                - L * steps) // L
              and counts["gelu_fwd"] == counts["flash_fwd"]
              and counts["gelu_bwd"] == L * steps,
              f"[finetune-lora] launches {counts}")
        losses = s["losses"]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"[finetune-lora] losses {losses}")
        arrs, _, _ = C.load_checkpoint(base)
        check(all(torch.equal(t, torch.as_tensor(arrs[k], device="cuda"))
                  and not t.requires_grad and t.grad is None
                  for k, t in s["base"].items()),
              "[finetune-lora] a base tensor changed or holds a gradient")
        tree, meta = CT.load_tree(args.out)
        check(set(tree) == set(s["lora"]) and meta["rank"] == 8,
              f"[finetune-lora] adapter file {sorted(tree)} {meta}")
        bcfg = cfg.replace(dtype="bfloat16")
        x = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(4))
        with torch.no_grad():
            want = M.gpt_forward(M.prepare_params(
                LO.apply_lora(s["base"], s["lora"]), bcfg), x, bcfg)
            marrs, _, _ = C.load_checkpoint(args.merge)
            got = M.gpt_forward(M.prepare_params(
                P.from_numpy(marrs, cfg, "cuda"), bcfg), x, bcfg)
        check(torch.equal(got, want), "[finetune-lora] the merged checkpoint's "
              f"logits differ: {(got.float() - want.float()).abs().max()}")
        step_ms = float(np.median([r["wall_s"] for r in s["log"][2:]])) * 1e3
        adapter_mb = os.path.getsize(args.out) / 1e6
        m, v = LO.init_lora_opt(s["lora"])
        y = torch.randint(0, cfg.vocab_size, (B, 1024), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(5))
        _, prof = profiling.trace(
            lambda: LO.lora_train_step(s["lora"], m, v, steps, s["base"],
                                       y, y.roll(-1, 1), bcfg, lr=1e-4),
            work, "lora_step")
        busy = _busy_share(prof, step_ms)
        del s, m, v
    print(f"[finetune-lora] gpt2-124m LoRA rank 8 ({LORA_PARAMS} adapter "
          f"params) bf16 B={B} T=1024 {steps} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {counts} (K1-fwd/K5 beyond 12/1 a "
          f"step: the held-out evaluation); adapters {adapter_mb:.2f} MB; "
          f"base unchanged, no base .grad; merged checkpoint's logits equal")
    print(f"[finetune-lora] steady (median of steps 3-{steps}): "
          f"{step_ms:.2f} ms/step vs full finetune {full_train['step_ms']:.2f};"
          f" max_memory_allocated {peak / 2**30:.3f} GiB vs full finetune "
          f"{full_train['peak_gib']:.3f} GiB (ratio "
          f"{peak / 2**30 / full_train['peak_gib']:.3f}); a traced step's "
          f"device busy {prof['busy_ms']} ms = {busy:.4f} of the step; wall "
          f"{wall:.1f} s  ({smi})")
    return counts, dict(step_ms=step_ms, peak_gib=peak / 2**30,
                        busy_ms=prof["busy_ms"], busy_share=busy,
                        groups=prof["groups"],
                        full_step_ms=full_train["step_ms"],
                        full_peak_gib=full_train["peak_gib"],
                        memory_ratio=peak / 2**30 / full_train["peak_gib"],
                        losses=losses, adapter_mb=adapter_mb, wall_s=wall)


def phase_train_clip(smi, steps=8, B=64):
    """The CLIP image tower clip-l-14 at full width and depth (24 x 1024,
    16 heads, T=257, 768-dim embeddings), B=64, fp32 masters and bf16
    compute: 8 steps of `clip_loss` against seeded random unit text
    embeddings, AdamW per tensor (`adamw_tree`, lr 1e-4, no decay) on one
    seeded batch: finite, falling loss; 24 K1-fwd, 24 K2 and 24 GELU
    launches each way a step and no other kernel; step ms (median of steps 3-8 by events), the busy share
    of a traced step, peak memory."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import clip as CLIP
    from vitrs_tpu_torch.ops import optimizer as opt
    from vitrs_tpu_torch.utils import profiling
    cfg = get_config("clip-l-14", dtype="bfloat16")
    check(P.num_parameters(cfg) == CLIP_L14_PARAMS,
          f"clip-l-14 parameter count {P.num_parameters(cfg)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = CLIP.init_clip_params(cfg, gen)
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    imgs = torch.randn(B, 224, 224, 3, generator=gen, device="cuda")
    txt = torch.randn(B, 768, generator=gen, device="cuda")
    txt = txt / txt.norm(dim=-1, keepdim=True)
    state = {"p": params, "m": m, "v": v}

    def step(i):
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in state["p"].items()}
        loss = CLIP.clip_loss(leaves, imgs, txt, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        g = {k: torch.zeros_like(t) if d is None else d
             for (k, t), d in zip(leaves.items(), grads)}
        state["p"], state["m"], state["v"] = opt.adamw_tree(
            state["p"], g, state["m"], state["v"], i, 1e-4)
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(float(step(i)))               # waits for the device
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    check(counts == designed(flash_fwd=L * steps, flash_bwd=L * steps,
                             gelu_fwd=L * steps, gelu_bwd=L * steps),
          f"[train-clip] launches {counts}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[train-clip] losses {losses}")
    step_ms = float(np.median(times[2:]))
    with tempfile.TemporaryDirectory() as work:
        _, prof = profiling.trace(lambda: step(steps + 1), work, "clip_step")
    busy = _busy_share(prof, step_ms)
    print(f"[train-clip] clip-l-14 ({CLIP_L14_PARAMS} params) bf16/fp32-"
          f"master B={B} T=257: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"losses {losses}")
    print(f"[train-clip] launches per step: flash_fwd "
          f"{counts['flash_fwd'] // steps}, flash_bwd "
          f"{counts['flash_bwd'] // steps}, gelu_fwd / gelu_bwd as many, "
          f"every other kernel 0; steady "
          f"(median of steps 3-{steps}): {step_ms:.2f} ms/step, "
          f"{B / step_ms * 1e3:.1f} images/s; traced step busy "
          f"{prof['busy_ms']} ms = {busy:.4f} of the step; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB  ({smi})")
    del state, params, m, v
    return counts, dict(step_ms=step_ms, imgs_s=B / step_ms * 1e3,
                        busy_share=busy, busy_ms=prof["busy_ms"],
                        groups=prof["groups"], peak_gib=peak / 2**30,
                        losses=losses)


def phase_quirks(smi):
    """quirks=True on the card.  (1) A GPT-2 124M quirk train step through
    dense attention, fp32, B=2, T=1024, through train/loop.train (2
    steps): finite, the loss (-p) in [-1, 0], no flash or CE kernel
    launched (K7 runs the update).  (2) gpt-nano's quirk loss and all 16
    gradients on the card against the port's numpy oracle
    (`model_forward(quirks=True)`, `model_backward_quirks`): loss rtol
    2e-5, gradients rtol 5e-4 with atol 2e-5 of the tensor's largest
    value, zero-gradient rows within 2e-4 of it.  (3) A quirk generate
    (GPT-2 124M, bf16, B=2, a 256-token prompt prefilled in chunks of 128,
    8 new tokens): no K1-fwd, K3-fwd or K4 launch."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.oracle import numpy_ref as ORACLE
    from vitrs_tpu_torch.train import loop
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="gpt2-124m", dataset="", steps=2,
                              batch_size=2, lr=1e-4, warmup=1,
                              dtype="float32", log_every=1, ckpt_every=0,
                              workdir=work, device="cuda",
                              model_overrides={"quirks": True})
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary = loop.train(tc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    # 2 steps of 12 layers: GELU, no flash or CE kernel
    check(counts == designed(adamw=2, gelu_fwd=2 * 12, gelu_bwd=2 * 12),
          f"[quirks] launches {counts}")
    check(-1.0 <= summary["final_loss"] <= 0.0,
          f"[quirks] loss {summary['final_loss']}")
    print(f"[quirks] gpt2-124m quirks=True fp32 B=2 T=1024, 2 steps through "
          f"dense attention: final loss {summary['final_loss']:.6f}; "
          f"launches {counts}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; wall "
          f"{wall:.1f} s  ({smi})")

    cfg = get_config("gpt-nano", quirks=True, use_flash=False)
    rng = np.random.default_rng(7)
    arrs = {k: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
            for k, a in ORACLE.init_parameters(P.param_shapes(cfg),
                                               seed=7).items()}
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    tgts = rng.integers(0, cfg.vocab_size, (2, 16))
    leaves = {k: t.requires_grad_(True)
              for k, t in P.from_numpy(arrs, cfg, "cuda").items()}
    loss = M.gpt_loss(leaves, torch.as_tensor(toks, device="cuda"),
                      torch.as_tensor(tgts, device="cuda"), cfg)
    loss.backward()
    want, acts = ORACLE.model_forward(arrs, toks, tgts, cfg.num_heads,
                                      quirks=True)
    grads = ORACLE.model_backward_quirks(arrs, acts, toks, tgts,
                                         cfg.num_heads)
    lerr = abs(loss.item() - want) / abs(want)
    check(lerr <= 2e-5, f"[quirks] gpt-nano loss {loss.item()} vs oracle "
          f"{want}")
    worst = 0.0
    for k, w in grads.items():
        g = leaves[k].grad.double().cpu().numpy()
        scale = max(np.abs(w).max(), 1e-12)
        d = np.abs(g - w)
        lim = 5e-4 * np.abs(w) + 2e-5 * scale
        check((d <= lim).all(), f"[quirks] d{k}: {(d > lim).sum()} values "
              f"beyond tolerance (max {d.max():.3e})")
        zero = w == 0.0
        if zero.any():
            check(d[zero].max() <= 2e-4 * scale, f"[quirks] d{k}: a "
                  f"zero-gradient row off by {d[zero].max():.3e}")
        worst = max(worst, float((d / lim).max()))
    print(f"[quirks] gpt-nano on the card vs the numpy oracle: loss rel err "
          f"{lerr:.2e}; 16 gradients within tolerance (worst {worst:.3f} of "
          f"it)")

    gcfg = get_config("gpt2-124m", quirks=True, dtype="bfloat16")
    pp = M.prepare_params(P.init_params(
        gcfg, torch.Generator(device="cuda").manual_seed(8)), gcfg)
    prompt = torch.randint(0, gcfg.vocab_size, (2, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(9))
    reset_counts()
    out = G.generate(pp, prompt, gcfg, max_new=8, temperature=0.0,
                     prefill_chunk=128)
    gen_counts = read_counts()
    # GELU a layer a prompt chunk (2) and a decode step (7)
    check(tuple(out.shape) == (2, 264)
          and gen_counts == designed(gelu_fwd=gcfg.num_layers * (2 + 7)),
          f"[quirks] generate shape {tuple(out.shape)}, launches {gen_counts}")
    print(f"[quirks] gpt2-124m quirk generate (B=2, 256-token prompt in "
          f"chunks of 128, 8 new): no flash kernel launched {gen_counts}")
    del pp
    return dict(final_loss=summary["final_loss"], counts=counts,
                nano_loss_rel_err=lerr, nano_grad_worst_of_tol=worst,
                generate_counts=gen_counts, wall_s=wall)


def phase_bitexact():
    """The bit-exact mode (ops/bitexact.py) on the card at the JAX test's
    size (B=2, T=4, C=16, NH=2, V=11, L=2), seeds 0 and 7: the loss and
    all 16 gradients == the port's scalar oracle (oracle/bitexact_ref.py)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.ops import bitexact as BX
    from vitrs_tpu_torch.oracle import bitexact_ref as REF
    from vitrs_tpu_torch.oracle import numpy_ref as ORACLE
    cfg = get_config("gpt-nano").replace(max_seq_len=4, vocab_size=11,
                                         num_layers=2, num_heads=2,
                                         channels=16)

    def bits(a):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, np.float32).view(np.uint32)

    out = {}
    for seed in (0, 7):
        params = ORACLE.init_parameters(P.param_shapes(cfg), seed=seed)
        rng = np.random.default_rng(seed + 1)
        inputs = rng.integers(0, 11, (2, 4)).astype(np.int32)
        targets = rng.integers(0, 11, (2, 4)).astype(np.int32)
        loss_ref, acts = REF.model_forward(params, inputs, targets, 2)
        g_ref = REF.model_backward(params, acts, inputs, targets, 2)
        t0 = time.perf_counter()
        loss, g = BX.loss_and_grads(params, inputs, targets, 2, device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(loss.is_cuda and bits(loss) == bits(loss_ref),
              f"[bitexact] seed {seed}: loss {loss.item()!r} != {loss_ref!r}")
        for k in g_ref:
            n = int((bits(g[k]) != bits(g_ref[k])).sum())
            check(n == 0, f"[bitexact] seed {seed}: d{k} differs in {n} "
                  f"values")
        out[seed] = dict(loss=float(loss_ref), ms=ms)
        print(f"[bitexact] seed {seed}: the loss {float(loss_ref)!r} and all "
              f"16 gradients on the card == the scalar oracle, bit for bit "
              f"({ms:.0f} ms of eager launches)")
    return out


def phase_import_hf():
    """The HF converters at GPT-2 124M and ViT-B/16 geometry, in numpy on
    the port's seeded random weights: export_*_state_dict then
    convert_*_state_dict gives back the same arrays, and the model built
    from them gives the same logits on the card (bf16, bit for bit).  No
    `transformers` is needed."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import import_hf as IH
    from vitrs_tpu_torch.models import model as M
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for family, preset in (("gpt2", "gpt2-124m"), ("vit", "vit-b-16")):
        cfg = get_config(preset, dtype="bfloat16")
        params = P.init_params(cfg, gen)
        arrs = P.to_numpy(params, cfg)
        sd = getattr(IH, f"export_{family}_state_dict")(arrs, cfg)
        back = getattr(IH, f"convert_{family}_state_dict")(sd, cfg)
        same = [k for k in arrs if k != "wte" or family == "gpt2"]
        check(all(np.array_equal(back[k], arrs[k]) for k in same),
              f"[import-hf] {family}: the round trip changed a tensor")
        if family == "gpt2":
            x = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                              generator=gen)
            fwd = M.gpt_forward
        else:
            x = torch.randn(8, 224, 224, 3, device="cuda", generator=gen)
            fwd = M.vit_forward
        with torch.no_grad():
            want = fwd(M.prepare_params(params, cfg), x, cfg)
            got = fwd(M.prepare_params(P.from_numpy(back, cfg, "cuda"), cfg),
                      x, cfg)
        check(torch.equal(got, want), f"[import-hf] {family}: logits differ")
        out[family] = dict(tensors=len(sd), logits=list(got.shape))
        print(f"[import-hf] {preset}: export -> {len(sd)} HF tensors -> "
              f"convert: the same arrays, logits {tuple(got.shape)} equal "
              f"bit for bit on the card")
        del params, arrs, sd, back
    return out


# --------------------------------------------------------------- PR 13 phases
# the kernels as torch.library ops, torch.export serving, the NaN guards,
# and the data-parallel families on ranks that share the card over gloo

OP_CHECKS = ("test_schema", "test_faketensor")


def phase_ops():
    """`torch.library.opcheck` (schema and fake tensor) of every `vitrs::`
    op on CUDA inputs at serving shapes, then the host cost of the
    dispatcher: K1-fwd at B=64 T=50 NH=12 (the host-bound shape) called
    through its wrapper and through the op, by events and by the host
    clock, in turns (wrapper, op, op, wrapper)."""
    from vitrs_tpu_torch.ops import basic
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    B, T, KH = 4, 1024, 4
    qkv = rnd(B, T, 3 * C)
    q, k, v = qkv.split(C, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, True, 0.125)
    do = rnd(B, T, C)
    g = rnd(B, T, C + 2 * KH * D)
    gq, gk, gv = FG.split_gqa(g, NH, KH)
    gout, glse = FG.flash_gqa_fwd_cuda(gq, gk, gv, NH, KH, True, 0.125)
    cache = rnd(1, 1024, 2 * KH * D)
    R, V, Vp = 4096, 50257, 50304
    logits = rnd(R, Vp)
    tgt = torch.randint(0, V, (R,), generator=gen, device="cuda")
    clse, _ = CE.ce_fwd_cuda(logits, tgt, V)
    n = 1 << 20
    h = rnd(B, T, 4 * C)
    cases = {
        "flash_fwd": (FA.flash_fwd_op, (q, k, v, NH, True, 0.125, 0, False)),
        "flash_bwd": (FA.flash_bwd_op, (q, k, v, out, lse, do, NH, True,
                                        0.125, 0, False)),
        "flash_gqa_fwd": (FG.flash_gqa_fwd_op,
                          (gq, gk, gv, NH, KH, True, 0.125, 0, False)),
        "flash_gqa_bwd": (FG.flash_gqa_bwd_op,
                          (gq, gk, gv, gout, glse, do, NH, KH, True, 0.125,
                           0, False)),
        "flash_prefill": (FP.flash_prefill_op,
                          (rnd(1, 256, C), cache[..., :KH * D],
                           cache[..., KH * D:], NH, KH, 256, 0.125, 0)),
        "ce_fwd": (CE.ce_fwd, (logits, tgt, V)),
        "ce_bwd": (CE.ce_bwd, (logits, tgt, clse,
                               torch.full((R,), 1.0 / R, device="cuda"), V)),
        "head_ce_fwd": (FH.head_ce_fwd, (rnd(1024, C), rnd(Vp, C),
                                         tgt[:1024], V)),
        "adamw_": (FW.adamw_op, (rnd(n, dtype=torch.float32),
                                 rnd(n, dtype=torch.float32),
                                 rnd(n, dtype=torch.float32),
                                 rnd(n, dtype=torch.float32).abs(), 3.0,
                                 1e-3, 0.9, 0.999, 1e-8, 0.1)),
        "gelu_fwd": (basic.gelu_fwd_op, (h, False)),
        "gelu_bwd": (basic.gelu_bwd_op, (h, rnd(B, T, 4 * C), True)),
    }
    res = {}
    for name, (op, args) in cases.items():
        got = torch.library.opcheck(op, args, test_utils=OP_CHECKS)
        check(all(v == "SUCCESS" for v in got.values()),
              f"[ops] opcheck {name}: {got}")
        res[name] = got
    torch.cuda.synchronize()
    print(f"[ops] opcheck {OP_CHECKS} on CUDA inputs: SUCCESS for "
          f"{len(res)} ops ({', '.join('vitrs::' + k for k in res)})")
    # the dispatcher's cost at the host-bound shape
    Bs, Ts = 64, 50
    qkv = rnd(Bs, Ts, 3 * C)
    q, k, v = qkv.split(C, dim=-1)
    direct = lambda: FA.flash_fwd_cuda(q, k, v, NH, False, 0.125)  # noqa: E731
    via_op = lambda: FA.flash_fwd_op(q, k, v, NH, False, 0.125, 0,  # noqa: E731
                                     False)

    def host_us(fn, iters=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / iters * 1e6

    ev = [cuda_ms(f, iters=200) for f in (direct, via_op, via_op, direct)]
    hu = [host_us(f) for f in (direct, via_op, via_op, direct)]
    timing = dict(direct_ms=(ev[0] + ev[3]) / 2, op_ms=(ev[1] + ev[2]) / 2,
                  direct_host_us=(hu[0] + hu[3]) / 2,
                  op_host_us=(hu[1] + hu[2]) / 2, events=ev, host_us=hu)
    print(f"[ops] K1-fwd B={Bs} T={Ts} NH={NH} bf16 non-causal: by events "
          f"{timing['direct_ms']:.4f} ms a call through the wrapper, "
          f"{timing['op_ms']:.4f} through vitrs::flash_fwd; host "
          f"{timing['direct_host_us']:.2f} us vs {timing['op_host_us']:.2f} "
          f"us a call (the dispatcher adds "
          f"{timing['op_host_us'] - timing['direct_host_us']:.2f} us); runs "
          f"{[round(x, 4) for x in ev]} ms, {[round(x, 2) for x in hu]} us")
    return dict(opcheck=res, dispatch=timing)


def _export_case(tag, cfg, params, x, eager, smi, work):
    """Export, load and call one model: the artifact's bytes, export and
    load seconds, ms a call beside the eager forward's, logits equal bit for
    bit and K1-fwd's launches a call."""
    from vitrs_tpu_torch import serving as S
    path = os.path.join(work, f"{tag}.vitrs")
    t0 = time.perf_counter()
    S.export_forward(params, cfg, x.shape[0], path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = S.ServedModel(path)
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        want = eager(x)
        reset_counts()
        got = served(x)
        torch.cuda.synchronize()
        counts = read_counts()
    check(counts == designed(flash_fwd=cfg.num_layers,
                             gelu_fwd=cfg.num_layers),
          f"[serve-export] {tag}: launches a call {counts}")
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"[serve-export] {tag}: {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"[serve-export] {tag}: exported logits "
          f"differ from the eager forward's (max {diff:.3e})")
    with torch.no_grad():
        ms = [cuda_ms(f, iters=10) for f in (lambda: eager(x),
                                             lambda: served(x),
                                             lambda: served(x),
                                             lambda: eager(x))]
    row = dict(bytes=os.path.getsize(path), export_s=export_s, load_s=load_s,
               ms=(ms[1] + ms[2]) / 2, eager_ms=(ms[0] + ms[3]) / 2,
               launches=counts["flash_fwd"], runs=ms)
    print(f"[serve-export] {tag} {tuple(x.shape)}: artifact "
          f"{row['bytes']} bytes, export {export_s:.2f} s, load "
          f"{load_s:.2f} s; logits {tuple(got.shape)} {str(got.dtype)[6:]} "
          f"equal to the eager forward bit for bit; K1-fwd "
          f"{row['launches']} launches a call; {row['ms']:.3f} ms a call "
          f"exported vs {row['eager_ms']:.3f} eager  ({smi})")
    return path, row


# the depth of the exported models: torch.export traces a graph a layer on
# the host, and every layer's ops are the same
EXPORT_LAYERS = 4


def phase_serve_export(smi, work):
    """GPT-2 124M (bf16, seeded weights, B=4, T=1024) and ViT-B/16 (B=64),
    both at full width and EXPORT_LAYERS of their 12 layers, through
    `serving.export_forward` and `ServedModel` on the card."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    res = {}
    cfg = get_config("gpt2-124m", dtype="bfloat16", num_layers=EXPORT_LAYERS)
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    pp = M.prepare_params(params, cfg)
    tok = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len),
                        device="cuda", dtype=torch.int32)
    _, res["gpt2-124m"] = _export_case(
        "gpt2-124m", cfg, params, tok,
        lambda t: M.gpt_forward(pp, t.long(), cfg), smi, work)
    del params, pp
    cfg = get_config("vit-b-16", dtype="bfloat16", num_layers=EXPORT_LAYERS)
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    pp = M.prepare_params(params, cfg)
    img = torch.randn(64, cfg.img_size, cfg.img_size, cfg.in_chans,
                      device="cuda")
    path, res["vit-b-16"] = _export_case(
        "vit-b-16", cfg, params, img,
        lambda t: M.vit_forward(pp, t, cfg, train=False), smi, work)
    res["vit_path"] = path
    return res


def phase_serve_batching(smi, vit_path, n=512, threads=8, B=64):
    """`BatchingServer` over the exported ViT-B/16 (batch 64, max_wait_ms
    5): 512 single-image requests from 8 threads, each submitting its 64 at
    once and then waiting; every result equals its row of the direct
    forward of the same images in batches of 64 (bit for bit: one batch
    shape, and no op mixes rows); images/s, p50 / p99 latency, batches."""
    import threading
    from vitrs_tpu_torch import serving as S
    served = S.ServedModel(vit_path)
    rng = np.random.default_rng(13)
    imgs = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    with torch.no_grad():
        direct = torch.cat([served(imgs[i:i + B]).float().cpu()
                            for i in range(0, n, B)]).numpy()
    srv = S.BatchingServer(served, batch_size=B, max_wait_ms=5.0)
    lat = np.zeros(n)
    got = [None] * n

    def client(t):
        mine = range(t, n, threads)
        sent = {i: (time.perf_counter(), srv.submit(imgs[i])) for i in mine}
        for i, (t0, fut) in sent.items():
            got[i] = fut.result(timeout=300)
            lat[i] = time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(t,))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in ts), "[serve-batching] hung")
    finally:
        srv.close()
    got = np.stack(got)
    bad = int((got != direct).any(axis=1).sum())
    check(bad == 0, f"[serve-batching] {bad} of {n} results differ from the "
          f"direct forward (max {np.abs(got - direct).max():.3e})")
    row = dict(images_s=n / wall, p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               batches=srv.batches, requests=n, threads=threads)
    print(f"[serve-batching] ViT-B/16 artifact, batch {B}, max_wait 5 ms: "
          f"{n} requests from {threads} threads in {srv.batches} batches, "
          f"{row['images_s']:.1f} images/s, latency p50 {row['p50_ms']:.2f} "
          f"ms p99 {row['p99_ms']:.2f} ms; every result equal to its row of "
          f"the direct batch-64 forward bit for bit  ({smi})")
    return row


def phase_debug():
    """utils/debug.py on the card: `checked` passes a clean GPT-2 124M
    forward (bf16, B=1, T=1024) and raises at the wte lookup when the row
    of a token it reads is NaN; `debug_mode` restores anomaly detection and
    takes its check away on exit."""
    from vitrs_tpu_torch.utils import debug as DBG
    cfg, pp = _gpt2_124m(seed=2)
    from vitrs_tpu_torch.models import model as M
    tok = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len),
                        device="cuda")
    fwd = DBG.checked(lambda p, t: M.gpt_forward(p, t, cfg))
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = fwd(pp, tok)
    clean_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "[debug] clean forward")
    bad = dict(pp, wte=pp["wte"].clone())
    bad["wte"][int(tok[0, 5])] = float("nan")
    try:
        with torch.no_grad():
            fwd(bad, tok)
        raise RuntimeError("[debug] a NaN wte row passed the check")
    except DBG.CheckError as e:
        check((e.op, e.kind) == ("__getitem__", "nan"), f"[debug] {e}")
        named = str(e)
    prev = torch.is_anomaly_enabled()
    with DBG.debug_mode():
        check(torch.is_anomaly_enabled(), "[debug] anomaly mode not on")
    x = torch.zeros(2, device="cuda")
    check(torch.is_anomaly_enabled() == prev and
          bool(torch.isnan(x / x).all()), "[debug] debug_mode left a flag")
    print(f"[debug] checked GPT-2 124M forward (B=1 T=1024 bf16): clean in "
          f"{clean_s:.2f} s (a host read after every op); NaN wte row -> "
          f"CheckError: {named}; debug_mode restored anomaly={prev} and its "
          f"check")
    return dict(clean_s=clean_s, error=named)


# ---- ranks sharing the card over gloo ---------------------------------------

XDP_OVR = dict(num_layers=2, num_heads=2, channels=128, max_seq_len=64,
               vocab_size=16500)
# one spawn a world size: (ranks, the meshes its ranks run in turn)
MESH_RUNS = ((2, ("dp=2", "fsdp=2")), (4, ("dp=2,fsdp=2",)))
TRAIN_STEPS = 6
# the depth of every full-width mesh run (meshes, meshes-tp-pp,
# meshes-cp-ep): the presets' widths at 4 of their 12 layers (divisible by
# the interleaved pipeline's pp x v = 4).  A run's time is its steps, its
# set-up and its fp32 gradient check, all linear in depth, on a host its
# ranks share; a layer's collectives, hops, all-to-alls and kernel routes
# are the same at any depth.
MESH_LAYERS = 4


def _xdp_cfg():
    from vitrs_tpu_torch.config import get_config
    return get_config("gpt-nano").replace(dtype="float32", **XDP_OVR)


def _xdp_data():
    from vitrs_tpu_torch import params as P
    cfg = _xdp_cfg()
    params = P.to_numpy(P.init_params(cfg, torch.Generator().manual_seed(3)),
                        cfg)
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.vocab_size, (4, 64))
    y = rng.integers(0, cfg.vocab_size, (4, 64))
    return cfg, params, x, y


def _xdp_step(spec, device):
    """One step of the small fp32 model under `spec` on this rank (the
    whole batch at world size 1): (loss, canonical params, m or the rank's
    m shard, grads of the whole batch's loss at world size 1)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.parallel import data_parallel as dp
    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.train import mesh as MS
    cfg, host, x, y = _xdp_data()
    world, rank = multihost.world_size(), multihost.rank()
    b = x.shape[0] // world
    xs, ys = x[rank * b:(rank + 1) * b], y[rank * b:(rank + 1) * b]
    if not MS.parse_mesh(spec).fsdp:
        mesh = dp.make_mesh(devices=[device])
        flat = P.flatten_params(P.from_numpy(host, cfg, device), cfg)
        params = P.unflatten_params(flat, cfg)
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        params, m, v, loss = dp.make_dp_train_step(cfg, mesh)(
            params, m, v, xs, ys, 1, 1e-3, 0.1)
        grads = {k: t.grad.cpu().numpy() for k, t in params.items()}
        return (loss.item(), P.to_numpy(params, cfg), m.cpu().numpy(), grads)
    plan = MS.make_plan(cfg, MS.parse_mesh(spec), "adamw", device)
    placed = plan.place(host)
    params, (m, _), loss = plan.step(placed, plan.init_opt(placed), xs, ys,
                                     1, 1e-3, 0.1)
    return (loss.item(), plan.to_canonical(params), plan.to_canonical(m),
            None)


def _rank_state_bytes(cfg, spec, device):
    """(bytes of this rank's parameters + optimizer state as the run holds
    them, the bytes spec_for / the ZeRO-1 slice predict)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.parallel import data_parallel as dp
    from vitrs_tpu_torch.parallel import fsdp as FS
    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.train import mesh as MS
    n = P.num_parameters(cfg)
    world = multihost.world_size()
    ms = MS.parse_mesh(spec)
    if not ms.fsdp:
        mesh = dp.make_mesh(devices=[device])
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        held = 4 * n + 4 * (m.numel() + v.numel())
        return held, 4 * n + 8 * (-(-n // world))
    plan = MS.make_plan(cfg, ms, "adamw", device)
    shapes = P.param_shapes(cfg)
    placed = plan.place({k: np.zeros(s, np.float32)
                         for k, s in shapes.items()})
    m, v = plan.init_opt(placed)
    held = 4 * sum(t.numel() for tree in (placed, m, v)
                   for t in tree.values())
    want = 12 * sum(int(np.prod(s)) // (1 if FS.spec_for(s, ms.fsdp) is None
                                        else ms.fsdp)
                    for s in shapes.values())
    return held, want


def _rank_main(rank, world, spec, rdv, work, out_path, dev="cuda:0",
               preset="gpt2-124m", specs=None):
    """One rank of a meshes spawn on `dev` (cuda:0, shared) over gloo: for
    each mesh of `specs` (default: spec alone) in turn, the small model's
    step (xdevice-dp), then `preset` through train/loop.train (train-*) in
    a workdir of its own (rank 0 keeps its metrics records); results under
    "runs", one a mesh.  dev "cpu" and a small preset rehearse it without
    a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.parallel import collectives as CL
    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.train import loop
    device = torch.device(dev)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    multihost.initialize("file://" + rdv, world, rank, backend="gloo",
                         device=dev, timeout=900)
    res = {"route": CL.route(None, device), "runs": []}
    for i, sp in enumerate(specs or (spec,)):
        run = {}
        reset_counts()
        run["xdp"] = _xdp_step(sp, device)
        run["xdp_counts"] = read_counts()
        cfg = get_config(preset, dtype="bfloat16", num_layers=MESH_LAYERS)
        run["state_bytes"] = _rank_state_bytes(cfg, sp, device)
        if cuda:
            torch.cuda.empty_cache()
        sizes, orig = [], FW.adamw_cuda

        def recording(p, *a, **k):
            sizes.append(p.numel())
            return orig(p, *a, **k)

        recording.launches = 0
        FW.adamw_cuda = recording
        reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        wd = os.path.join(work, str(i))
        t0 = time.perf_counter()
        try:
            summary = loop.train(loop.TrainConfig(
                preset=preset, dataset="", steps=TRAIN_STEPS, batch_size=8,
                lr=6e-4, warmup=2, min_lr=6e-5, weight_decay=0.1,
                dtype="bfloat16", log_every=1, ckpt_every=0, workdir=wd,
                mesh=sp, device=dev,
                model_overrides={"num_layers": MESH_LAYERS}))
            if cuda:
                torch.cuda.synchronize()
            counts = read_counts()      # the recording wrapper holds K7's
        finally:
            FW.adamw_cuda = orig
        run.update(counts=counts, adamw_sizes=sorted(set(sizes)),
                   peak=torch.cuda.max_memory_allocated() if cuda else 0,
                   wall=time.perf_counter() - t0,
                   final_loss=summary["final_loss"])
        if rank == 0:
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                run["recs"] = [json.loads(line) for line in f]
        res["runs"].append(run)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def _mesh_run(spec, world, target=None, **kw):
    """Spawn `world` ranks of `spec` on cuda:0 running `target` (default
    `_rank_main`; kw: its keyword arguments); returns their results, the
    run's metrics records and the wall seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        work = os.path.join(d, "work")
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=target or _rank_main,
                             args=(r, world, spec, os.path.join(d, "rdv"),
                                   work, outs[r]), kwargs=kw)
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        # a rank that fails leaves the others waiting in a collective: stop
        # them all at the first failure
        deadline = time.perf_counter() + 900
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode not in (None, 0) for p in procs)
               and time.perf_counter() < deadline):
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"[mesh {spec}] rank exit codes {codes}")
        res = [torch.load(o, weights_only=False) for o in outs]
        recs = None
        if os.path.exists(os.path.join(work, "metrics.jsonl")):
            with open(os.path.join(work, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
    return res, recs, time.perf_counter() - t0


def _hold(tag, got, want, rtol, atol, grads=None, lr=0.0):
    """Hold canonical arrays to a reference: rtol, atol; where |grad| <
    1e-6 (fp32 noise) within lr (AdamW from zero moments moves such a value
    by lr g / (|g| + eps)); qkvb's k third (an exactly-zero gradient) left
    out.  Returns the largest error."""
    worst = 0.0
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
        tol = np.full(w.shape, atol, np.float32)
        if grads is not None:
            tol[np.abs(grads[k]) < 1e-6] = lr
        if k == "qkvb":
            Cq = w.shape[-1] // 3
            g, w, tol = (np.concatenate([a[..., :Cq], a[..., 2 * Cq:]], -1)
                         for a in (g, w, tol))
        err = np.abs(g - w)
        check(bool((err <= tol + rtol * np.abs(w)).all()),
              f"{tag}: {k} max err {err.max():.3e}")
        worst = max(worst, float(err.max()))
    return worst


def phase_meshes(smi, dev="cuda:0", preset="gpt2-124m"):
    """xdevice-dp and train-dp / train-fsdp / train-hybrid: for each of
    dp=2, fsdp=2 (2 ranks: one spawn runs both) and dp=2,fsdp=2 (4
    ranks), ranks that share
    cuda:0 over gloo run (a) one step of a small fp32 model (D=64, so that
    it takes the kernels), held against one process stepping the whole
    batch: ZeRO-1 at tests/test_data_parallel.py's tolerances (loss rtol
    1e-5, params rtol 2e-4 atol 5e-5, m rtol 2e-4 atol 1e-7), FSDP and the
    hybrid at tests/test_fsdp.py's (loss rtol 1e-6, params rtol 2e-6 atol
    1e-7), values whose gradient is fp32 noise within lr; (b) GPT-2 124M at
    full width and MESH_LAYERS of its layers through train/loop.train,
    global B=8, T=1024, 6 steps: finite, falling loss, each rank's
    launches a step (K1-fwd and K2 once a layer, K5 1, K6 1, K7 1 over its
    half of the parameters on the ZeRO-1
    path), its parameter + state bytes equal to what the shards predict,
    its peak; step ms (ranks time-sliced on one card: not a scaling
    number).  dev "cpu" and a small preset rehearse it without a card."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    device = torch.device(dev)
    res = {}
    refs = {kind: _xdp_step(kind, device) for kind in ("dp=1", "fsdp=1")}
    n124 = P.num_parameters(get_config(preset, num_layers=MESH_LAYERS))
    runs = []
    for world, specs in MESH_RUNS:
        ranks, _, wall = _mesh_run(specs[0], world, dev=dev, preset=preset,
                                   specs=specs)
        runs += [(spec, world, ranks[0]["route"], [r["runs"][i] for r in ranks],
                  wall) for i, spec in enumerate(specs)]
    for spec, world, route, ranks, wall in runs:
        recs = ranks[0]["recs"]
        tag = f"[mesh {spec}]"
        zero1 = "fsdp" not in spec
        lref, pref, mref, gref = refs["dp=1" if zero1 else "fsdp=1"]
        gref = gref if gref is not None else refs["dp=1"][3]
        rtol, atol, ltol = ((2e-4, 5e-5, 1e-5) if zero1
                            else (2e-6, 1e-7, 1e-6))
        perr = merr = 0.0
        for r, out in enumerate(ranks):
            loss, params, m, _ = out["xdp"]
            check(abs(loss - lref) <= ltol * abs(lref),
                  f"{tag} xdevice loss {loss} vs one process {lref}")
            perr = max(perr, _hold(f"{tag} xdevice rank {r}", params, pref,
                                   rtol, atol, gref, 1e-3))
            if zero1:
                k = -(-_xdp_n() // world)
                want = np.asarray(mref)[r * k:(r + 1) * k]
                got = np.asarray(m)[:want.shape[0]]
                err = np.abs(got - want)
                check(bool((err <= 1e-7 + 2e-4 * np.abs(want)).all()),
                      f"{tag} xdevice m shard {r} max err {err.max():.3e}")
                merr = max(merr, float(err.max()))
            else:
                merr = max(merr, _hold(f"{tag} xdevice m", m, mref, 2e-6,
                                       1e-7))
        L, S = MESH_LAYERS, TRAIN_STEPS
        want = designed(flash_fwd=L * S, flash_bwd=L * S, ce_fwd=S, ce_bwd=S,
                        adamw=S if zero1 else 0, gelu_fwd=L * S,
                        gelu_bwd=L * S)
        for r, out in enumerate(ranks):
            check(out["counts"] == want,
                  f"{tag} rank {r} launches {out['counts']} != {want}")
            held, pred = out["state_bytes"]
            check(held == pred, f"{tag} rank {r} state bytes {held} != "
                  f"predicted {pred}")
            if zero1:
                check(out["adamw_sizes"] == [n124 // world],
                      f"{tag} rank {r} K7 sizes {out['adamw_sizes']}")
        losses = [rec["loss"] for rec in recs]
        check(len(losses) == S and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"{tag} losses {losses}")
        ips = float(np.median([rec["imgs_per_sec"] for rec in recs[2:]]))
        step_ms = 8 / ips * 1e3
        row = dict(world=world, route=route, xdevice_loss=lref,
                   xdevice_param_err=perr, xdevice_m_err=merr,
                   losses=losses, step_ms=step_ms,
                   launches_per_step={k: v // S for k, v in
                                      ranks[0]["counts"].items() if v},
                   adamw_values=ranks[0]["adamw_sizes"],
                   state_bytes=[o["state_bytes"][0] for o in ranks],
                   peak_gib=[o["peak"] / 2**30 for o in ranks],
                   spawn_wall_s=wall)
        res[spec] = row
        print(f"{tag} {world} ranks on {dev} over {row['route']}: "
              f"xdevice step vs one process: loss {lref:.6f}, params max err "
              f"{perr:.3e}, m max err {merr:.3e}")
        print(f"{tag} {preset} B=8 T=1024 {S} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches a step per "
              f"rank {row['launches_per_step']}"
              + (f", K7 over {row['adamw_values']} values" if zero1 else "")
              + f"; parameter + state bytes a rank {row['state_bytes']} "
              f"(as predicted); peak a rank "
              f"{[round(x, 3) for x in row['peak_gib']]} GiB; {step_ms:.1f} "
              f"ms a step (ranks time-sliced on one card, not a scaling "
              f"number); the spawn's wall {wall:.1f} s  ({smi})")
    return res


def _xdp_n():
    from vitrs_tpu_torch import params as P
    return P.num_parameters(_xdp_cfg())


def phase_comm_nccl():
    """A one-rank NCCL group on cuda:0: each collective the port uses
    (parallel/collectives.py) once on CUDA tensors.  NCCL between cards is
    not verified here: the machine has one."""
    import torch.distributed as dist
    from vitrs_tpu_torch.parallel import collectives as CL
    from vitrs_tpu_torch.parallel import multihost
    with tempfile.TemporaryDirectory() as d:
        check(multihost.initialize(f"file://{d}/rdv", 1, 0, device="cuda:0",
                                   timeout=120), "[comm-nccl] no group")
        try:
            backend = dist.get_backend()
            check(backend == "nccl", f"[comm-nccl] backend {backend}")
            x = torch.arange(1024, dtype=torch.float32, device="cuda")
            out = torch.empty_like(x)
            CL.all_reduce(x.clone())
            CL.reduce_scatter(out, x)
            check(torch.equal(out, x), "[comm-nccl] reduce_scatter")
            CL.all_gather(out, x * 2)
            check(torch.equal(out, x * 2), "[comm-nccl] all_gather")
            y = x.clone()
            CL.broadcast(y, 0)
            CL.barrier()
            torch.cuda.synchronize()
            check(torch.equal(y, x), "[comm-nccl] broadcast")
            route = CL.route(None, "cuda:0")
        finally:
            dist.destroy_process_group()
    print(f"[comm-nccl] one-rank {route} group on cuda:0: all_reduce, "
          f"reduce_scatter, all_gather, broadcast, barrier ran on CUDA "
          f"tensors; NCCL between cards is not verified (one card)")
    return dict(backend=route, collectives=5)


# ---- tensor, sequence, vocab and pipeline parallelism, the 3-D mesh ---------

# (B, T, NH, causal) of K1-fwd / K2 on these families' paths: GPT-2 124M
# under tp=2 (6 heads a rank), a pipeline microbatch (B=8 over mb=4), and
# ViT-B/16 under tp=2
# (B, T, NH, causal): tp=2, a pipeline microbatch, ViT-B/16 under tp=2;
# gpt2-moe-8e's rows a rank under ep=2 (NH=12) and ep=2,tp=2 (NH=6)
TP_PP_SHAPES = ((8, 1024, 6, True), (2, 1024, 12, True), (64, 197, 6, False),
                (4, 1024, 12, True), (4, 1024, 6, True))


def phase_kernels_tp_pp():
    """K1-fwd and K2 (bf16) at TP_PP_SHAPES against their plain versions
    (K1-fwd to `out_errors`, values beyond it held to the fp64 softmax
    where causal; lse 1e-4; dq/dk/dv 2e-2 abs + rel, kernels-train's),
    then kernel and plain by events (plain, kernel, kernel, plain), the
    kernel's device time by the profiler, SDPA's forward and backward on
    the same tensors, and the bound (`fwd_bound` / `bwd_bound`)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(14)
    res = {}
    for B, T, nh, causal in TP_PP_SHAPES:
        Cv = nh * D
        qkv = torch.randn(B, T, 3 * Cv, generator=gen,
                          device="cuda").bfloat16()
        do = torch.randn(B, T, Cv, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.split(Cv, dim=-1)
        shape = (f"bf16 B={B} T={T} NH={nh} D=64 "
                 f"{'causal' if causal else 'non-causal'}")
        out, lse = FA.flash_fwd_cuda(q, k, v, nh, causal, 0.125)
        ref, ref_lse = FA.flash_fwd_plain(q, k, v, nh, causal, 0.125)
        torch.cuda.synchronize()
        bad, err, rms = out_errors(out, ref)
        if causal:
            judged = exact_check(f"K1-fwd {shape}", q, k, v, out, ref, 0.125)
        else:
            check(bad == 0, f"K1-fwd {shape}: {bad} out values beyond "
                  f"tolerance")
            judged = "0 held"
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-4, f"K1-fwd {shape}: lse err {lse_err}")
        got = FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, causal, 0.125)
        want = FA.flash_bwd_plain(q, k, v, out, lse, do, nh, causal, 0.125)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            d = (a.float() - b.float()).abs()
            nbad = ((d > 2e-2 + 2e-2 * b.float().abs()).sum().item()
                    + (~torch.isfinite(a)).sum().item())
            check(nbad == 0, f"K2 {shape}: {nbad} {name} values beyond 2e-2")
            errs.append(d.max().item())
        del ref, ref_lse, got, want
        if causal:
            lib_f = (lambda: sdpa(q, k, v, nh, nh, True))
            lib_b = sdpa_bwd(q, k, v, do, nh, nh, True)
        else:
            lib_f = (lambda: sdpa(q, k, v, nh, nh, causal=False))
            lib_b = sdpa_bwd(q, k, v, do, nh, nh, causal=False)
        parts = {
            "flash_fwd": (lambda: FA.flash_fwd_cuda(q, k, v, nh, causal,
                                                    0.125),
                          lambda: FA.flash_fwd_plain(q, k, v, nh, causal,
                                                     0.125), lib_f, 2, 1,
                          err),
            "flash_bwd": (lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, nh,
                                                    causal, 0.125),
                          lambda: FA.flash_bwd_plain(q, k, v, out, lse, do,
                                                     nh, causal, 0.125),
                          lib_b, 5, 3, max(errs))}
        for kname, (kern, plain, lib_fn, passes, nk, e) in parts.items():
            km, pm, raw = timed_pair(kern, plain)
            dev, caps = device_ms(kern, nk)
            lib = cuda_ms(lib_fn)
            flops, (bms, by) = (
                fwd_bound(B, nh, nh, D, T, 0, T, 2, causal)
                if passes == 2 else bwd_bound(B, nh, nh, D, T, 2, causal))
            name = "K1-fwd" if kname == "flash_fwd" else "K2"
            print(f"[kernels-tp-pp] {name} {shape}: max_abs_err {e:.3e}"
                  + (f" (out rms {rms:.3e}, {judged}, lse {lse_err:.3e})"
                     if kname == "flash_fwd" else
                     f" (dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e})")
                  + f"; kernel {raw[0]:.4f}/{raw[1]:.4f} ms by events, "
                  f"{dev if dev is None else round(dev, 4)} ms device "
                  f"(capture {caps}); plain {raw[2]:.4f}/{raw[3]:.4f} ms; "
                  f"SDPA {lib:.4f} ms; bound {bms:.4f} ms ({by}), "
                  f"{flops / km / 1e9:.1f} TFLOP/s")
            res.setdefault(kname, {})[f"B={B} T={T} NH={nh}"] = dict(
                max_abs_err=e, ms=km, device_ms=dev, device_captures=caps,
                plain_ms=pm, library_ms=lib, bound_ms=bms, bound_by=by,
                tflops=flops / km / 1e9, shape=shape)
        del qkv, do, q, k, v, out, lse
    return res


XTP_OVR = dict(XDP_OVR, num_layers=4)     # interleaved v=2 needs L % 4 == 0
# one spawn a row, one a world size (its ranks run every mesh of the row
# in turn; process start-up and set-up, not the steps, dominate a spawn):
# (ranks, the small model's steps (spec, optimizer), the full-width runs
# (preset, spec, global B) through train/loop.train)
TP_PP_RUNS = (
    (2, (("tp=2", "adamw"), ("tp=2", "adafactor"), ("tp=2", "muon"),
         ("pp=2", "adamw"), ("pp=2,schedule=1f1b,mb=4", "adamw"),
         ("pp=2,schedule=1f1b-interleaved,v=2,mb=4", "adamw"),
         ("pp=2,schedule=1f1b,mb=4", "adafactor")),
     (("gpt2-124m", "tp=2", 8), ("vit-b-16", "tp=2", 64),
      ("gpt2-124m", "pp=2,schedule=1f1b,mb=4", 8),
      ("gpt2-124m", "pp=2,schedule=1f1b-interleaved,v=2,mb=4", 8))),
    (4, (("dp=2,tp=2,sp,vp", "adamw"), ("tp=2,pp=2", "adamw"),
         ("tp=2,pp=2", "adafactor")),
     (("gpt2-124m", "dp=2,tp=2,sp,vp", 8), ("gpt2-124m", "tp=2,pp=2", 8))),
)
# the small steps' lr, and the seventh slot (wd; Muon: its AdamW lr)
SMALL_LR = {"adamw": (1e-3, 0.1), "adafactor": (1e-2, 0.1),
            "muon": (0.02, 3e-3)}


def _xtp_cfg():
    from vitrs_tpu_torch.config import get_config
    return get_config("gpt-nano").replace(dtype="float32", **XTP_OVR)


def _xtp_data():
    from vitrs_tpu_torch import params as P
    cfg = _xtp_cfg()
    params = P.to_numpy(P.init_params(cfg, torch.Generator().manual_seed(4)),
                        cfg)
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfg.vocab_size, (4, 64))
    y = rng.integers(0, cfg.vocab_size, (4, 64))
    return cfg, params, x, y


def _xtp_reference(device):
    """One process stepping the whole batch of the small model: (loss,
    grads, {(family kind, optimizer): canonical params after one step}).
    The steps are the one-device counterparts of the mesh steps: AdamW on
    every leaf; Muon (`ops/muon.step`); Adafactor in each family's layout
    (TP: the TP leaves, factored on their whole shapes; pipeline: the
    canonical leaves with the (L, C) stacks full-v; 3-D: both)."""
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.ops import muon as MU
    from vitrs_tpu_torch.ops import optimizer as opt
    from vitrs_tpu_torch.parallel import pipeline as PPm
    from vitrs_tpu_torch.parallel import tensor_parallel as TPm
    from vitrs_tpu_torch.parallel import threed as TD
    cfg, host, x, y = _xtp_data()
    p = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in host.items()}
    loss = M.loss_fn(p, torch.as_tensor(x, device=device),
                     torch.as_tensor(y, device=device), cfg)
    loss.backward()
    g = {k: t.grad for k, t in p.items()}
    p = {k: t.detach() for k, t in p.items()}
    out = {}
    lr, wd = SMALL_LR["adamw"]
    z = {k: torch.zeros_like(t) for k, t in p.items()}
    out["adamw"] = opt.adamw_tree(p, g, z, dict(z), 1, lr, weight_decay=wd)[0]
    lr, alr = SMALL_LR["muon"]
    out["muon"] = MU.step(p, g, MU.init_state(p), 1, lr, alr)[0]
    lr, wd = SMALL_LR["adafactor"]
    for kind, (fac, gshapes), tp in (
            ("tp", TPm.tp_af_factored(cfg), True),
            ("pp", PPm.pp_af_factored(cfg), False),
            ("3d", TD.threed_af_factored(cfg), True)):
        pl, gl = ((TPm.to_tp_params(t, cfg) for t in (p, g)) if tp
                  else (p, g))
        shapes = AF.state_shapes(gshapes, fac)
        st = AF.AdafactorState(*({k: torch.zeros(s, device=device)
                                  for k, s in getattr(shapes, f).items()}
                                 for f in ("vr", "vc", "vf")), {})
        new = AF.step(pl, gl, st, 1, lr, weight_decay=wd,
                      decay_mask=opt.decay_mask_2d(pl), factored=fac)[0]
        out[f"adafactor/{kind}"] = TPm.from_tp_params(new, cfg) if tp else new
    to_np = lambda t: {k: v.cpu().numpy() for k, v in t.items()}  # noqa: E731
    return loss.item(), to_np(g), {k: to_np(v) for k, v in out.items()}


def _tp_pp_state_bytes(cfg, plan):
    """(bytes of this rank's parameters + AdamW m, v as placed, the bytes
    the specs predict: 12 per value of each leaf's slice)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.parallel import pipeline as PPm
    from vitrs_tpu_torch.parallel import tensor_parallel as TPm
    from vitrs_tpu_torch.parallel import threed as TD
    vp = plan.spec.vp
    if plan.kind == "tp":
        specs, shapes = (TPm.tp_param_specs(cfg, vp),
                         TPm.tp_global_shapes(cfg, vp))
    elif plan.kind == "pp":
        specs = PPm.pp_param_specs(cfg)
        shapes = {k: tuple(s) for k, s in P.param_shapes(cfg).items()}
    else:
        specs, shapes = (TD.param_specs_3d(cfg, vp),
                         TPm.tp_global_shapes(cfg, vp))
    placed = plan.place({k: np.zeros(s, np.float32)
                         for k, s in P.param_shapes(cfg).items()})
    m, v = plan.init_opt(placed)
    held = 4 * sum(t.numel() for tree in (placed, m, v)
                   for t in tree.values())
    want = 12 * sum(int(np.prod(TPm.local_shape(s, specs[k], plan.mesh)))
                    for k, s in shapes.items())
    return held, want


def _tp_pp_rank(rank, world, spec, rdv, work, out_path, dev="cuda:0",
                small=(), runs=()):
    """One rank of a meshes-tp-pp spawn on `dev` (cuda:0, shared) over
    gloo: each small step of `small` (spec, optimizer), then each run of
    `runs` (preset, spec, global B) through train/loop.train, 6 steps (vit:
    of a 7-step schedule, so that rank 0's end-of-run evaluation adds no
    launches), each in its own workdir.  dev "cpu" and a small preset
    rehearse it without a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.parallel import collectives as CL
    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.train import loop
    from vitrs_tpu_torch.train import mesh as MS
    device = torch.device(dev)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    multihost.initialize("file://" + rdv, world, rank, backend="gloo",
                         device=dev, timeout=900)
    res = {"route": CL.route(None, device), "small": {}, "runs": []}
    cfg, host, x, y = _xtp_data()
    for sspec, optimizer in small:
        plan = MS.make_plan(cfg, MS.parse_mesh(sspec), optimizer, device)
        b = x.shape[0] // plan.data_ways
        rows = slice(plan.data_rank * b, (plan.data_rank + 1) * b)
        placed = plan.place(host)
        lr, seventh = SMALL_LR[optimizer]
        out = plan.step(placed, plan.init_opt(placed), x[rows], y[rows], 1,
                        lr, seventh)
        res["small"][(sspec, optimizer)] = dict(
            kind=plan.kind, loss=float(out[2]),
            params=plan.to_canonical(out[0]))
    for i, (preset, rspec, batch) in enumerate(runs):
        cfg = get_config(preset, dtype="bfloat16", num_layers=MESH_LAYERS)
        plan = MS.make_plan(cfg, MS.parse_mesh(rspec), "adamw", device)
        row = {"state_bytes": _tp_pp_state_bytes(cfg, plan),
               "kind": plan.kind}
        del plan
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        vit = cfg.mode == "vit"
        wd = os.path.join(work, str(i))
        reset_counts()
        t0 = time.perf_counter()
        summary = loop.train(loop.TrainConfig(
            preset=preset, dataset="synthetic-imagenet" if vit else "",
            dataset_size=batch if vit else 0,
            steps=TRAIN_STEPS + (1 if vit else 0), run_steps=TRAIN_STEPS,
            batch_size=batch, lr=3e-4 if vit else 6e-4, warmup=2,
            min_lr=1e-5 if vit else 6e-5, weight_decay=0.05 if vit else 0.1,
            dtype="bfloat16", log_every=1, ckpt_every=0, workdir=wd,
            mesh=rspec, device=dev, prefetch=0,
            model_overrides={"num_layers": MESH_LAYERS}))
        if cuda:
            torch.cuda.synchronize()
        row.update(counts=read_counts(),
                   peak=torch.cuda.max_memory_allocated() if cuda else 0,
                   wall=time.perf_counter() - t0,
                   final_loss=summary["final_loss"])
        if rank == 0:
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                row["recs"] = [json.loads(line) for line in f]
        res["runs"].append(row)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def _designed_tp_pp(kind, spec, rank, data, S=TRAIN_STEPS):
    """The launches a rank makes over S steps of GPT-2 124M / ViT-B/16
    (MESH_LAYERS layers) under `spec`: K1-fwd and K2 once a local layer a
    microbatch (the port keeps each microbatch's graph: no recompute);
    K5 and K6 once a microbatch on the last stage of a non-VP gpt head; no
    K7 (`adamw_tree`, as in JAX)."""
    from vitrs_tpu_torch.train import mesh as MS
    ms = MS.parse_mesh(spec)
    mb = (ms.microbatches or ms.pp) if ms.pp > 1 else 1
    layers = MESH_LAYERS // ms.pp
    last = ms.pp == 1 or rank % ms.pp == ms.pp - 1
    ce = mb if (last and not ms.vp and data == "gpt") else 0
    return designed(flash_fwd=layers * mb * S, flash_bwd=layers * mb * S,
                    ce_fwd=ce * S, ce_bwd=ce * S,
                    gelu_fwd=layers * mb * S, gelu_bwd=layers * mb * S)


def phase_meshes_tp_pp(smi, dev="cuda:0"):
    """TP_PP_RUNS: ranks that share cuda:0 over gloo (every collective and
    pipeline hop staged through host memory) run (a) one step of the small
    fp32 model (XTP_OVR: D=64, so the kernels; 4 layers) under each family
    and optimizer, held against one process stepping the whole batch
    (`_xtp_reference`) at the CPU tests' tolerances: loss rtol 2e-5;
    params AdamW rtol 2e-4 atol 5e-5, Adafactor rtol 1e-4 atol 2e-4, Muon
    rtol 5e-3 atol 2e-3, a value whose gradient is fp32 noise within lr;
    (b) GPT-2 124M (B=8, T=1024) or ViT-B/16 (B=64) at full width and
    depth through train/loop.train, 6 steps: finite, falling loss, each
    rank's launches equal to `_designed_tp_pp`, its parameter + state
    bytes equal to what its slices predict, its peak; step ms (ranks
    time-sliced on one card: not a scaling number)."""
    device = torch.device(dev)
    lref, gref, pref = _xtp_reference(device)
    res = {}
    for world, small, runs in TP_PP_RUNS:
        ranks, _, wall = _mesh_run(runs[0][1], world, target=_tp_pp_rank,
                                   dev=dev, small=small, runs=runs)
        for sspec, optimizer in small:
            tag = f"[meshes-tp-pp {sspec}]"
            worst = 0.0
            for r, out in enumerate(ranks):
                got = out["small"][(sspec, optimizer)]
                key = (optimizer if optimizer != "adafactor"
                       else f"adafactor/{got['kind']}")
                check(abs(got["loss"] - lref) <= 2e-5 * abs(lref),
                      f"{tag} small {optimizer} rank {r} loss {got['loss']} "
                      f"vs one process {lref}")
                rtol, atol = {"adamw": (2e-4, 5e-5), "adafactor": (1e-4, 2e-4),
                              "muon": (5e-3, 2e-3)}[optimizer]
                lr = SMALL_LR[optimizer][1 if optimizer == "muon" else 0]
                worst = max(worst, _hold(f"{tag} small {optimizer} rank {r}",
                                         got["params"], pref[key], rtol, atol,
                                         gref, lr))
            res[f"small {sspec} {optimizer}"] = dict(
                world=world, loss=lref, param_err=worst)
            print(f"{tag} small fp32 step, {optimizer}: loss {lref:.6f} as "
                  f"one process on every rank; params max err {worst:.3e}")
        for i, (preset, spec, batch) in enumerate(runs):
            tag = f"[meshes-tp-pp {preset} {spec}]"
            outs = [o["runs"][i] for o in ranks]
            data = "vit" if preset.startswith("vit") else "gpt"
            for r, out in enumerate(outs):
                want = _designed_tp_pp(out["kind"], spec, r, data)
                check(out["counts"] == want,
                      f"{tag} rank {r} launches {out['counts']} != {want}")
                h, pred = out["state_bytes"]
                check(h == pred, f"{tag} rank {r} state bytes {h} != "
                      f"predicted {pred}")
            recs = outs[0]["recs"]
            losses = [rec["loss"] for rec in recs]
            check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
                  and losses[-1] < losses[0], f"{tag} losses {losses}")
            ips = float(np.median([rec["imgs_per_sec"] for rec in recs[2:]]))
            step_ms = batch / ips * 1e3
            row = dict(world=world, kind=outs[0]["kind"],
                       route=ranks[0]["route"], losses=losses,
                       step_ms=step_ms,
                       launches_per_step=[{k: v // TRAIN_STEPS for k, v in
                                           o["counts"].items() if v}
                                          for o in outs],
                       state_bytes=[o["state_bytes"][0] for o in outs],
                       peak_gib=[o["peak"] / 2**30 for o in outs],
                       run_wall_s=[o["wall"] for o in outs], spawn_wall_s=wall)
            res[f"{preset} {spec}"] = row
            print(f"{tag} B={batch} {TRAIN_STEPS} steps, {world} ranks on "
                  f"{dev} over {row['route']}: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; launches a step per rank "
                  f"{row['launches_per_step']} (as designed); parameter + "
                  f"state bytes a rank {row['state_bytes']} (as predicted); "
                  f"peak a rank {[round(x, 3) for x in row['peak_gib']]} "
                  f"GiB; {step_ms:.1f} ms a step (ranks time-sliced on one "
                  f"card, not a scaling number); the spawn's wall {wall:.1f} "
                  f"s  ({smi})")
    return res


# ---- context and expert parallelism -------------------------------------------

# (name, B, T/cp, kv_heads, window) of the ring's per-hop kernel routes at
# the smoke's cp shapes: GPT-2 124M-4k under cp=2 (B=4, T=4096: 2048 a
# rank), its GQA form (4 kv heads) and the train-window model under cp=2
# (rope + W=1024, 4 kv heads, B=2, T=8192: 4096 a rank), and that window
# at MHA (12 kv heads)
CP_ROUTES = (("mha", 4, 2048, NH, 0), ("gqa", 4, 2048, 4, 0),
             ("band", 2, 4096, 4, 1024), ("band-mha", 2, 4096, NH, 1024))
# (kv_heads, dtype, Tq, Tk, q_offset, window) of the direct rectangle
# checks, B=2: the 8K window's cut hop at MQA; W above T/cp (T/cp=100,
# W=250: the hop 3 blocks back); a frontier inside the rows without a
# window; rows 139..199 that see no key; on the FMA instances the small
# fp32 banded mesh run's cut hop (T/cp=32, W=24), the frontier without a
# window and the no-key rows
CP_RECTS = ((1, "bf16", 1023, 1023, 1023, 1024), (4, "bf16", 49, 49, 249, 250),
            (4, "bf16", 77, 301, 250, 0), (NH, "bf16", 200, 150, 100, 90),
            (1, "fp32", 23, 23, 23, 24), (4, "fp32", 77, 301, 250, 0),
            (NH, "fp32", 200, 150, 100, 90))


def sdpa_kv(q, k, v, kh, causal, mask=None):
    """PyTorch's SDPA at kv width kh, causal, full or under a mask (a
    yardstick only)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        heads(q, NH), heads(k, kh), heads(v, kh), attn_mask=mask,
        is_causal=causal and mask is None, enable_gqa=kh != NH)


def sdpa_kv_bwd(q, k, v, do, kh, causal, mask=None):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa_kv(*leaves, kh, causal, mask)
    dout = heads(do, NH)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def cp_bound(B, tq, keys, kh, passes, causal, window=0, q_off=0):
    """(operations, (bound_ms, bound_by)) of a bf16 ring hop at NH=12 D=64:
    2 D flops a product per (query, key) pair (the diagonal's causal
    triangle or band, a past block's tq x keys, a cut hop's visible pairs
    at q_off: about tq^2/2 on the 8K window), passes 2 forward (reads
    q, k, v, writes out, lse) or 5 backward (reads q, k, v, out, do, lse,
    writes dq, dk, dv)."""
    pairs = attn_pairs(tq, q_off, keys, causal, window)
    flops = 2 * passes * B * NH * D * pairs
    n = 2 if passes == 2 else 4
    nbytes = (n * B * tq * C * 2 + n * B * keys * kh * D * 2
              + B * NH * tq * 4)
    return flops, bound(flops, "bf16", nbytes)


def grad_errors(got, want, parts=None, rows=True):
    """(elements beyond tolerance, max_abs_err, rms of want) of a ring
    hop's bf16 gradient (dq, dk or dv, (B, T, width)) against its plain
    version, or of the hops' fp32 sum against the plain gradient of the
    whole sequence (`parts`: the sum of the hops' magnitudes,
    elementwise):
      |d| <= 2^-7 (max(|got|, |want|) + parts) + 2^-6 max(rms, row rms),
    rms that of want, row rms that of want's row (one position, every
    channel).  Each side rounds one fp32 result to bf16, and ulp(x) <=
    2^-7 |x|; a sum of bf16 hops rounds each hop once, by at most half an
    ulp of that hop.  Before that the kernel and the plain version round p
    and ds to bf16 from fp32 values that differ in their last bits, and
    where they round apart one term of the row's sum moves by 2^-8 of
    itself: the rms term, which follows the size of the row's terms.  The
    first causal rows put weights near 1 on a few keys, so their terms
    are several times the tensor's rms, and there a value near 0 can move
    by 1e-3 (rows=False drops the row rms, to count what the tensor's rms
    alone would reject).  The bound follows the
    tensor's and the row's size, not the largest value: these gradients
    are heavy-tailed (the first keys' dk and dv are a hundred times the
    typical value), so a bound on the largest value would pass a hop
    dropped or halved almost everywhere, where this one fails it."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    row = (w.square().mean(-1, keepdim=True).sqrt().clamp(min=rms) if rows
           else rms)
    size = torch.maximum(g.abs(), w.abs())
    if parts is not None:
        size = size + parts
    lim = 2.0 ** -7 * size + 2.0 ** -6 * row
    bad = (d > lim).sum().item() + (~torch.isfinite(g)).sum().item()
    return bad, d.max().item(), rms


def _grad_errs(tag, got, want, parts=(None,) * 3):
    """Largest |got - want| of each (dq, dk, dv) pair, every value within
    `grad_errors`' bound."""
    errs = []
    for name, a, b, s in zip(("dq", "dk", "dv"), got, want, parts):
        bad, err, rms = grad_errors(a, b, s)
        check(bad == 0, f"{tag}: {bad} {name} values beyond the bound "
              f"(max_abs_err {err:.3e}, rms {rms:.3e})")
        errs.append(err)
    return errs


def summed_hops(g0, g1, gp):
    """The ring's (dq, dk, dv) of two blocks in fp32 from rank 0's diagonal
    hop g0, rank 1's diagonal hop g1 and its past hop gp (rank 1's queries
    against block 0's keys: dq to block 1, dk and dv to block 0), and the
    sum of the summed hops' magnitudes (0 where one hop alone gives the
    value), for `grad_errors`."""
    f = [[t.float() for t in g] for g in (g0, g1, gp)]
    (q0, k0, v0), (q1, k1, v1), (qp, kp, vp) = f
    got = (torch.cat([q0, q1 + qp], 1), torch.cat([k0 + kp, k1], 1),
           torch.cat([v0 + vp, v1], 1))
    z = torch.zeros_like
    parts = (torch.cat([z(q0), q1.abs() + qp.abs()], 1),
             torch.cat([k0.abs() + kp.abs(), z(k1)], 1),
             torch.cat([v0.abs() + vp.abs(), z(v1)], 1))
    return got, parts


def cut_hop_grads(g, T, rows, first):
    """A cut hop's (dq, dk, dv) on its rectangle placed in the whole blocks
    in fp32, as the ring adds them: dq in the first `rows` queries, dk and
    dv in the keys from `first` on, zeros elsewhere."""
    out = []
    for t, at in zip(g, (slice(0, rows), slice(first, T), slice(first, T))):
        full = t.new_zeros((t.shape[0], T, t.shape[2]), dtype=torch.float32)
        full[:, at] = t.float()
        out.append(full)
    return out


def _rect_checks(gen, device):
    """The kernels on CP_RECTS' rectangles (a query offset past the keys'
    end) against their plain versions, from the kernel forward's out and
    lse: out `out_errors`; lse 1e-4 where a row sees a key, -inf in both
    where it sees none, and there out 0 and dq 0; bf16 dq/dk/dv
    `grad_errors`, fp32 1e-4 abs + rel (kernels-train's K2 fp32)."""
    res = {}
    for kh, dt, Tq, Tk, off, W in CP_RECTS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        rnd = lambda n, w: torch.randn(2, n, w, generator=gen,  # noqa: E731
                                       device=device).to(dtype)
        q, k, v, do = rnd(Tq, C), rnd(Tk, kh * D), rnd(Tk, kh * D), rnd(Tq, C)
        fk, fp, bk, bp = _attn_fns(kh)
        where = (f"[kernels-cp rect] {dt} KH={kh} {Tq} rows at q_offset {off}"
                 f" against {Tk} keys W={W}")
        out, lse = fk(q, k, v, True, W, False, off)
        ref, ref_lse = fp(q, k, v, True, W, False, off)
        torch.cuda.synchronize()
        bad, err, rms = out_errors(out, ref)
        check(bad == 0, f"{where}: {bad} out values beyond tolerance "
              f"(max_abs_err {err:.3e})")
        blind = torch.isneginf(ref_lse)
        check(torch.equal(blind, torch.isneginf(lse)), f"{where}: the rows "
              f"that see no key differ")
        lerr = (lse - ref_lse)[~blind].abs().max().item()
        check(lerr <= 1e-4, f"{where}: lse err {lerr}")
        n_blind = int(blind[0, 0].sum().item())
        rows_blind = blind[:, 0, :, None]     # (B, Tq, 1): alike in every head
        gk = bk(q, k, v, out, lse, do, True, W, False, off)
        gp = bp(q, k, v, out, lse, do, True, W, False, off)
        torch.cuda.synchronize()
        if n_blind:
            check(bool((out * rows_blind == 0).all() and (gk[0] * rows_blind
                                                           == 0).all()),
                  f"{where}: a row that sees no key has a non-zero out or dq")
        if dtype == torch.bfloat16:
            errs = _grad_errs(f"{where} bwd", gk, gp)
        else:
            errs = []
            for name, a, b in zip(("dq", "dk", "dv"), gk, gp):
                d = (a.float() - b.float()).abs()
                nbad = ((d > 1e-4 + 1e-4 * b.float().abs()).sum().item()
                        + (~torch.isfinite(a)).sum().item())
                check(nbad == 0, f"{where} bwd: {nbad} {name} values beyond "
                      f"1e-4")
                errs.append(d.max().item())
        print(f"{where}: out max_abs_err {err:.3e} (rms {rms:.3e}), lse "
              f"{lerr:.3e}, {n_blind} rows see no key (out, lse, dq as "
              f"the plain version); dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/"
              f"{errs[2]:.3e}")
        res[f"{dt} KH={kh} {Tq}x{Tk} q_offset={off} W={W}"] = dict(
            out_err=err, lse_err=lerr, grad_errs=errs, rows_see_no_key=n_blind)
    # under rope the wrappers refuse queries past the keys' end (the ring
    # rotates q and k before it): forward and backward raise ValueError
    fk, _, bk, _ = _attn_fns(4)
    q, k = (torch.zeros(1, 8, w, dtype=torch.bfloat16, device=device)
            for w in (C, 4 * D))
    lse = torch.zeros(1, NH, 8, device=device)
    refused = []
    for part, call in (("fwd", lambda: fk(q, k, k, True, 0, True, 4)),
                       ("bwd", lambda: bk(q, k, k, q, lse, q, True, 0, True,
                                          4))):
        try:
            call()
        except ValueError:
            refused.append(part)
    check(refused == ["fwd", "bwd"], f"[kernels-cp rect] rope past the "
          f"keys' end: only {refused} refused")
    print("[kernels-cp rect] rope with the queries past the keys' end: "
          "refused forward and backward (ValueError)")
    return res


def phase_kernels_cp(device="cuda"):
    """The ring's per-hop routes at CP_ROUTES (bf16), on two ring blocks of
    one process: the diagonal hop (K1-fwd / K3-fwd causal, with the window;
    K2 / K3-bwd) and the past hop (non-causal kernels, or, where the band
    cuts it, the causal banded kernels on the rectangle the band reaches:
    1023 rows at q_offset 1023 against 1023 keys), each kernel held
    against its plain version (out `out_errors`, the MHA diagonal's values
    beyond it held to the fp64 softmax; lse 1e-4; dq/dk/dv `grad_errors`),
    then the fp32 lse merge of rank 1's hops against the plain forward of
    its queries over the whole sequence (out `out_errors`, lse 2e-4), and
    the hops' summed gradients against the plain backward of the whole
    sequence from the merged out and lse (`grad_errors`, which must also
    fail the sum with rank 1's past hop dropped or halved).  Times by
    events (plain, kernel, kernel, plain) and device, SDPA on the same
    tensors (under a band mask on the rectangle), the bound (`cp_bound`:
    a cut hop's visible pairs).  Then the direct rectangle checks
    (`_rect_checks`)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.parallel import ring_attention as RA
    gen = torch.Generator(device=device).manual_seed(15)
    res = {"merge": {}}
    for name, B, T, kh, W in CP_ROUTES:
        kv = kh * D
        rnd = lambda w: torch.randn(B, 2 * T, w, generator=gen,  # noqa: E731
                                    device=device).bfloat16()
        q2, k2, v2, do2 = rnd(C), rnd(kv), rnd(kv), rnd(C)
        blk = lambda t, r: t[:, r * T:(r + 1) * T].contiguous()  # noqa: E731
        q0, q1, k0, k1, v0, v1, do0, do1 = (blk(t, r) for t in
                                            (q2, k2, v2, do2) for r in (0, 1))
        fk, fp, bk, bp = _attn_fns(kh)
        ring1 = RA.Ring(1, 2, (0, 1))
        past_route = RA._route(ring1, 0, T, True, W)
        # the cut hop's rectangle (as the ring forms it)
        rows, first = RA._band_window(T, T, T, 0, W)
        off = T - first
        shape = (f"bf16 B={B} T/cp={T} NH={NH} KH={kh} D=64"
                 + (f" W={W}" if W else ""))
        kname = ("flash_fwd", "flash_bwd") if kh == NH else (
            "flash_gqa_fwd", "flash_gqa_bwd")
        # the forward hops of both ranks and their merge, as the ring merges
        o0, l0 = fk(q0, k0, v0, True, W, False)
        od, ld = fk(q1, k1, v1, True, W, False)
        acc, lse1 = RA._merge(None, None, od, ld)
        if past_route == "past":
            acc, lse1 = RA._merge(acc, lse1, *fk(q1, k0, v0, False, 0, False))
        else:
            op, lp = fk(q1[:, :rows], k0[:, first:], v0[:, first:], True, W,
                        False, off)
            acc[:, :rows], lse1[..., :rows] = RA._merge(
                acc[:, :rows], lse1[..., :rows], op, lp)
        out1 = acc.to(torch.bfloat16)
        ref, ref_lse = FA.flash_fwd_plain(q1, k2, v2, NH, True, 0.125,
                                          kv_heads=kh, q_offset=T, window=W)
        torch.cuda.synchronize()
        bad, merr, rms = out_errors(out1, ref)
        check(bad == 0, f"[kernels-cp {name}] merged rank-1 out: {bad} "
              f"values beyond tolerance")
        mlse = (lse1 - ref_lse).abs().max().item()
        check(mlse <= 2e-4, f"[kernels-cp {name}] merged lse err {mlse}")
        # the backward hops from the global out and lse, summed as the ring
        # sums them, against the plain backward of the whole sequence
        g0 = bk(q0, k0, v0, o0, l0, do0, True, W, False)
        g1 = bk(q1, k1, v1, out1, lse1, do1, True, W, False)
        if past_route == "past":
            gp = bk(q1, k0, v0, out1, lse1, do1, False, 0, False)
        else:
            gp = cut_hop_grads(bk(
                q1[:, :rows], k0[:, first:], v0[:, first:], out1[:, :rows],
                lse1[..., :rows].contiguous(), do1[:, :rows], True, W, False,
                off), T, rows, first)
        got, parts = summed_hops(g0, g1, gp)
        want = FA.flash_bwd_plain(q2, k2, v2, torch.cat([o0, out1], 1),
                                  torch.cat([l0, lse1], 2), do2, NH, True,
                                  0.125, kv_heads=kh, window=W)
        berr = _grad_errs(f"[kernels-cp {name}] summed ring gradients",
                          got, want, parts)
        flat = [grad_errors(a, b, c, rows=False)[0]
                for a, b, c in zip(got, want, parts)]
        # the same bound must fail the sum with rank 1's past hop dropped
        # or halved, in each of dq, dk and dv
        caught = {}
        for fault, s in (("dropped", 0.0), ("halved", 0.5)):
            bad_got, bad_parts = summed_hops(g0, g1, [s * t for t in gp])
            caught[fault] = [grad_errors(a, b, c)[0] for a, b, c in
                             zip(bad_got, want, bad_parts)]
            check(min(caught[fault]) > 0, f"[kernels-cp {name}] the bound "
                  f"misses the past hop {fault}: dq/dk/dv values beyond "
                  f"it {caught[fault]}")
        res["merge"][name] = dict(out_err=merr, out_rms=rms, lse_err=mlse,
                                  grad_errs=berr, faults_caught=caught,
                                  beyond_tensor_rms_floor=flat,
                                  grad_rms=[grad_errors(w, w)[2]
                                            for w in want],
                                  past_route=past_route, shape=shape)
        print(f"[kernels-cp] {name} {shape}: rank 1's merged hops vs the "
              f"plain forward over the whole sequence: out max_abs_err "
              f"{merr:.3e} (rms {rms:.3e}), lse {mlse:.3e}; summed ring "
              f"gradients vs the plain backward dq/dk/dv {berr[0]:.3e}/"
              f"{berr[1]:.3e}/{berr[2]:.3e} (rms "
              f"{'/'.join(f'{x:.3e}' for x in res['merge'][name]['grad_rms'])}"
              f"; dq/dk/dv values past the bound with the past hop dropped "
              f"{caught['dropped']}, halved {caught['halved']}; past it "
              f"without the row rms {flat}) "
              f"(past hop: {past_route})")
        del ref, ref_lse, want, got
        # each kernel hop against its plain version, and its times: (route,
        # q, k, v, causal, window, q_offset, out, lse, do)
        hops = [("diag", q1, k1, v1, True, W, 0, out1, lse1, do1)]
        if past_route == "past":
            hops.append(("past", q1, k0, v0, False, 0, 0, out1, lse1, do1))
        else:
            hops.append(("cut", q1[:, :rows], k0[:, first:], v0[:, first:],
                         True, W, off, out1[:, :rows],
                         lse1[..., :rows].contiguous(), do1[:, :rows]))
        for route, q, k, v, causal, w, o_, out_, lse_, do_ in hops:
            tq, keys = q.shape[1], k.shape[1]
            out, lse = fk(q, k, v, causal, w, False, o_)
            pref, plse = fp(q, k, v, causal, w, False, o_)
            torch.cuda.synchronize()
            if causal and not w and kh == NH:
                judged = exact_check(f"K1-fwd cp {name} {route}", q, k, v,
                                     out, pref, 0.125)
            else:
                b_, _, _ = out_errors(out, pref)
                check(b_ == 0, f"[kernels-cp {name} {route}] fwd: {b_} out "
                      f"values beyond tolerance")
                judged = "0 held"
            ferr = (out.float() - pref.float()).abs().max().item()
            lerr = (lse - plse).abs().max().item()
            check(lerr <= 1e-4, f"[kernels-cp {name} {route}] lse err {lerr}")
            gk = bk(q, k, v, out_, lse_, do_, causal, w, False, o_)
            gpl = bp(q, k, v, out_, lse_, do_, causal, w, False, o_)
            errs = _grad_errs(f"[kernels-cp {name} {route}] bwd", gk, gpl)
            del pref, plse, gk, gpl
            mask = band_mask(tq, o_, keys, w, device) if w else None
            hshape = shape + (" causal" if causal else " non-causal") + (
                f" cut: {tq} rows at q_offset {o_} against {keys} keys"
                if route == "cut" else "")
            parts = {
                kname[0]: (lambda: fk(q, k, v, causal, w, False, o_),
                           lambda: fp(q, k, v, causal, w, False, o_),
                           lambda: sdpa_kv(q, k, v, kh, causal, mask), 2, 1,
                           ferr),
                kname[1]: (lambda: bk(q, k, v, out_, lse_, do_, causal, w,
                                      False, o_),
                           lambda: bp(q, k, v, out_, lse_, do_, causal, w,
                                      False, o_),
                           sdpa_kv_bwd(q, k, v, do_, kh, causal, mask), 5, 3,
                           max(errs))}
            for kn, (kern, plain, lib_fn, passes, nk, e) in parts.items():
                km, pm, raw = timed_pair(kern, plain, iters=10)
                dev, caps = device_ms(kern, nk)
                lib = cuda_ms(lib_fn, iters=10)
                flops, (bms, by) = cp_bound(B, tq, keys, kh, passes, causal,
                                            w, o_)
                label = ("K1-fwd" if kn == "flash_fwd" else "K2"
                         if kn == "flash_bwd" else "K3-fwd"
                         if kn == "flash_gqa_fwd" else "K3-bwd")
                print(f"[kernels-cp] {label} {route} hop {hshape}: "
                      f"max_abs_err {e:.3e}"
                      + (f" ({judged}, lse {lerr:.3e})"
                         if passes == 2 else
                         f" (dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/"
                         f"{errs[2]:.3e}, from the merged out and lse)")
                      + f"; kernel {raw[0]:.4f}/{raw[1]:.4f} ms by events, "
                      f"{dev if dev is None else round(dev, 4)} ms device "
                      f"(capture {caps}); plain {raw[2]:.4f}/{raw[3]:.4f} ms; "
                      f"SDPA{' + band mask' if w else ''} {lib:.4f} ms; bound "
                      f"{bms:.4f} ms ({by}), {flops / km / 1e9:.1f} TFLOP/s "
                      f"by events")
                res.setdefault(kn, {})[f"{name} {route}"] = dict(
                    max_abs_err=e, ms=km, device_ms=dev, device_captures=caps,
                    plain_ms=pm, library_ms=lib, bound_ms=bms, bound_by=by,
                    tflops=flops / km / 1e9, shape=hshape)
            del out, lse
        del q2, k2, v2, do2, out1, lse1, acc
        torch.cuda.empty_cache()
    res["rect"] = _rect_checks(gen, device)
    return res


# the small fp32 model (D=64: the kernels) of the meshes-cp-ep steps: dense,
# banded (rope, W=24 and one kv head: every past hop of cp=2's T/cp=32 is
# cut by the band), and MoE without drops (4 experts, cap factor 8, no
# load-balance loss: the one-process step is the same function)
CP_EP_SMALL = {"dense": {}, "banded": dict(pos_emb="rope", window=24,
                                           num_kv_heads=1),
               "moe": dict(num_experts=4, moe_top_k=2, moe_cap_factor=8.0,
                           moe_aux_weight=0.0)}
# one spawn a row: (ranks, the small steps (spec, optimizer, variant), the
# full-width runs (name, preset, spec, global B, optimizer, TrainConfig
# fields) through train/loop.train)
CP_EP_RUNS = (
    (2, (("cp=2", "adamw", "dense"), ("cp=2", "adamw", "banded"),
         ("cp=2", "adafactor", "dense"), ("ep=2", "adamw", "moe"),
         ("ep=2", "adafactor", "moe")),
     (("cp-4k", "gpt2-124m-4k", "cp=2", 4, "adamw",
       dict(lr=6e-4, model_overrides=dict(num_layers=MESH_LAYERS))),
      ("cp-window", "gpt2-124m", "cp=2", 2, "adafactor",
       dict(lr=1e-2, kv_heads=4,
            model_overrides=dict(WINDOW, num_layers=MESH_LAYERS))),
      ("ep", "gpt2-moe-8e", "ep=2", 8, "adamw",
       dict(lr=6e-4, clip_norm=1.0,
            model_overrides=dict(num_layers=MESH_LAYERS))))),
    (4, (("ep=2,tp=2", "adamw", "moe"), ("ep=2,tp=2", "adafactor", "moe")),
     (("ep-tp", "gpt2-moe-8e", "ep=2,tp=2", 8, "adafactor",
       dict(lr=1e-2, model_overrides=dict(num_layers=MESH_LAYERS))),)),
)


def _small_cfg(variant):
    from vitrs_tpu_torch.config import get_config
    return get_config("gpt-nano").replace(dtype="float32", **XDP_OVR,
                                          **CP_EP_SMALL[variant])


def _cp_ep_reference(device):
    """One process stepping the whole batch of each small variant: {variant:
    (loss, grads, {(optimizer, layout): canonical params after one step})}.
    AdamW: K7's flat update without a decay mask (cp) and `adamw_tree`
    with the 2-D mask (ep); Adafactor on the canonical leaves (cp, dp x
    ep) or the TP layout (ep x tp, factored on the whole shapes)."""
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.ops import optimizer as opt
    from vitrs_tpu_torch.parallel import tensor_parallel as TPm
    _, _, x, y = _xdp_data()
    out = {}
    for variant in CP_EP_SMALL:
        cfg = _small_cfg(variant)
        from vitrs_tpu_torch import params as P
        host = P.to_numpy(P.init_params(cfg, torch.Generator().manual_seed(3)),
                          cfg)
        p = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in host.items()}
        loss = M.loss_fn(p, torch.as_tensor(x, device=device),
                         torch.as_tensor(y, device=device), cfg)
        loss.backward()
        g = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
             for k, t in p.items()}
        p = {k: t.detach() for k, t in p.items()}
        steps = {}
        lr, wd = SMALL_LR["adamw"]
        z = {k: torch.zeros_like(t) for k, t in p.items()}
        for layout, mask in (("cp", None), ("ep", opt.decay_mask_2d(p))):
            steps[("adamw", layout)] = opt.adamw_tree(
                p, g, z, dict(z), 1, lr, weight_decay=wd, decay_mask=mask)[0]
        lr, wd = SMALL_LR["adafactor"]
        steps[("adafactor", "cp")] = AF.step(
            p, g, AF.init_state(p), 1, lr, weight_decay=wd,
            decay_mask=opt.decay_mask_2d(p))[0]
        steps[("adafactor", "ep")] = steps[("adafactor", "cp")]
        if variant == "moe":
            fac, gshapes = TPm.tp_af_factored(cfg)
            pl, gl = (TPm.to_tp_params(t, cfg) for t in (p, g))
            shapes = AF.state_shapes(gshapes, fac)
            st = AF.AdafactorState(*({k: torch.zeros(s, device=device)
                                      for k, s in getattr(shapes, f).items()}
                                     for f in ("vr", "vc", "vf")), {})
            steps[("adafactor", "eptp")] = TPm.from_tp_params(AF.step(
                pl, gl, st, 1, lr, weight_decay=wd,
                decay_mask=opt.decay_mask_2d(pl), factored=fac)[0], cfg)
        to_np = lambda t: {k: v.cpu().numpy() for k, v in t.items()}  # noqa
        out[variant] = (loss.item(), to_np(g),
                        {k: to_np(v) for k, v in steps.items()})
    return out


def _cp_ep_state_bytes(cfg, plan):
    """(bytes of this rank's parameters + optimizer state as placed, the
    bytes its slicing predicts: cp whole parameters and a 1/(dp*cp) ZeRO-1
    m and v, or a whole Adafactor state; ep each leaf's slice, AdamW's m
    and v alike, Adafactor's state sliced as `state_specs` says)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.parallel import expert_parallel as EPm
    from vitrs_tpu_torch.parallel import tensor_parallel as TPm
    placed = plan.place({k: np.zeros(s, np.float32)
                         for k, s in P.param_shapes(cfg).items()})
    st = plan.init_opt(placed)
    trees = [placed] + (list(st[:3]) if isinstance(st, AF.AdafactorState)
                        else [{"m": st[0], "v": st[1]}] if plan.kind == "cp"
                        else list(st))
    held = 4 * sum(t.numel() for tree in trees for t in tree.values())
    mesh = plan.mesh
    if plan.kind == "cp":
        shapes = {k: tuple(s) for k, s in P.param_shapes(cfg).items()}
        specs = {k: () for k in shapes}
    elif plan.spec.tp > 1:
        shapes = TPm.tp_global_shapes(cfg, plan.spec.vp)
        specs = EPm.ep_tp_param_specs(cfg, plan.spec.vp)
    else:
        shapes = {k: tuple(s) for k, s in P.param_shapes(cfg).items()}
        specs = EPm.ep_param_specs(cfg)
    local = lambda s, sp: int(np.prod(TPm.local_shape(s, sp, mesh)))  # noqa
    n_p = sum(local(s, specs[k]) for k, s in shapes.items())
    if plan.optimizer == "adamw":
        n_st = (2 * st[0].numel() if plan.kind == "cp" else 2 * n_p)
        if plan.kind == "cp":
            n = P.num_parameters(cfg)
            world = mesh.size("data") * mesh.size("ctx")
            check(st[0].numel() == -(-n // world), "cp m shard size")
    else:
        fac = ({k: AF.factored_shape(s) for k, s in shapes.items()}
               if plan.kind == "cp" or plan.spec.tp > 1 else
               EPm.ep_af_factored(cfg, mesh)[0])
        sh, sp = AF.state_shapes(shapes, fac), AF.state_specs(shapes, specs,
                                                              fac)
        n_st = sum(local(s, getattr(sp, f)[k]) for f in ("vr", "vc", "vf")
                   for k, s in getattr(sh, f).items())
    return held, 4 * (n_p + n_st)


def _full_width_grads(cfg, rspec, optimizer, preset, batch, rank, device):
    """The mesh's fp32 loss and gradient on a full-width run's first global
    batch from its initial parameters (the loop's seed and loader; each
    rank's rows r::data_ways and its sequence block, as the loop feeds
    it; `cfg` in fp32, so that one process and the mesh differ only in
    summation order), gathered to canonical names, against one process's
    on the same batch: `model.loss_fn` in rank 0's process, no collective,
    its loss the mean over the data_ways row groups (each routing at its
    own capacity, as an ep rank does; the whole batch under cp).  Rank 0
    returns (mesh loss, one-process loss, {leaf: |g - g1| / |g1|, L2}, the
    one-process loss in the run's bf16: what the loop's step 1 logs); the
    other ranks None."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.train import loop
    from vitrs_tpu_torch.train import mesh as MS
    cfg32 = cfg.replace(dtype="float32")
    plan = MS.make_plan(cfg32, MS.parse_mesh(rspec), optimizer, device)
    tc = loop.TrainConfig(preset=preset, dataset="", batch_size=batch)
    loader, _ = loop._loader(tc, cfg, 0, device_normalize=False,
                             shard=(0, 1))
    x, y = loader.next_batch()
    host = P.to_numpy(P.init_params(
        cfg, torch.Generator().manual_seed(tc.seed)), cfg)
    n, t = plan.data_ways, x.shape[1] // plan.seq_ways
    blk = (slice(plan.data_rank, None, n),
           slice(plan.seq_rank * t, (plan.seq_rank + 1) * t))
    loss, g = plan.grads(plan.place(host), np.ascontiguousarray(x[blk]),
                         np.ascontiguousarray(y[blk]))
    got = plan.to_canonical(g)
    loss = float(loss)
    del g, plan
    if rank:
        return None
    p = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in host.items()}
    xs, ys = (torch.as_tensor(a, device=device).long() for a in (x, y))

    def one(c):
        return sum(M.loss_fn(p, xs[r::n], ys[r::n], c)
                   for r in range(n)) / n
    with torch.no_grad():
        bf16 = one(cfg).item()
    ref = one(cfg32)
    ref.backward()
    errs = {}
    for k, leaf in p.items():
        want = (leaf.grad if leaf.grad is not None
                else torch.zeros_like(leaf))
        d = (torch.as_tensor(got[k], device=device) - want).norm().item()
        w = want.norm().item()
        errs[k] = d / w if w > 0 else d
    return loss, ref.item(), errs, bf16


# the flash kernels' plain versions called on CUDA tensors in this process
# (`_watch_plain`): none may be, the ring's cut hop included
PLAIN_ON_CARD = {"fwd": 0, "bwd": 0}


def _watch_plain():
    """Stand counting wrappers in for the flash plain versions in every
    module that binds them (ops/flash_attention.py, flash_attention_gqa.py,
    flash_prefill.py), once a process: a call on CUDA tensors adds one to
    PLAIN_ON_CARD."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    if getattr(FA.flash_fwd_plain, "watched", False):
        return

    def watched(fn, d):
        def f(q, *a, **kw):
            PLAIN_ON_CARD[d] += q.is_cuda
            return fn(q, *a, **kw)
        f.watched = True
        return f

    for name, d in (("flash_fwd_plain", "fwd"), ("flash_bwd_plain", "bwd")):
        fn = watched(getattr(FA, name), d)
        for mod in (FA, FG, FP):
            if hasattr(mod, name):
                setattr(mod, name, fn)


def _cp_ep_rank(rank, world, spec, rdv, work, out_path, dev="cuda:0",
                small=(), runs=()):
    """One rank of a meshes-cp-ep spawn on `dev` (cuda:0, shared) over
    gloo: each small step of `small` (spec, optimizer, variant), then each
    run of `runs`: its gradient on the first batch against one process
    (`_full_width_grads`), then 6 steps through train/loop.train, each in
    its own workdir; dev "cpu" and small presets rehearse it without a
    card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.parallel import collectives as CL
    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.parallel import ring_attention as RA
    from vitrs_tpu_torch.train import loop
    from vitrs_tpu_torch.train import mesh as MS
    device = torch.device(dev)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    multihost.initialize("file://" + rdv, world, rank, backend="gloo",
                         device=dev, timeout=900)
    res = {"route": CL.route(None, device), "small": {}, "runs": []}
    _, _, x, y = _xdp_data()
    for sspec, optimizer, variant in small:
        cfg = _small_cfg(variant)
        host = P.to_numpy(P.init_params(cfg, torch.Generator().manual_seed(3)),
                          cfg)
        plan = MS.make_plan(cfg, MS.parse_mesh(sspec), optimizer, device)
        b = x.shape[0] // plan.data_ways
        t = x.shape[1] // plan.seq_ways
        rows = slice(plan.data_rank * b, (plan.data_rank + 1) * b)
        cols = slice(plan.seq_rank * t, (plan.seq_rank + 1) * t)
        placed = plan.place(host)
        lr, seventh = SMALL_LR[optimizer]
        out = plan.step(placed, plan.init_opt(placed), x[rows][:, cols],
                        y[rows][:, cols], 1, lr, seventh)
        res["small"][(sspec, optimizer, variant)] = dict(
            kind=plan.kind, loss=float(out[2]),
            params=plan.to_canonical(out[0]))
    for i, (name, preset, rspec, batch, optimizer, fields) in enumerate(runs):
        fields = dict(fields)
        cfg = _run_cfg(preset, fields)
        plan = MS.make_plan(cfg, MS.parse_mesh(rspec), optimizer, device)
        row = {"state_bytes": _cp_ep_state_bytes(cfg, plan), "kind": plan.kind,
               "grads": _full_width_grads(cfg, rspec, optimizer, preset,
                                          batch, rank, device)}
        del plan
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        wd = os.path.join(work, str(i))
        reset_counts()
        _watch_plain()
        band = RA.band_hops
        for d in ("fwd", "bwd"):
            band[d] = PLAIN_ON_CARD[d] = 0
        lr = fields.pop("lr")
        t0 = time.perf_counter()
        summary = loop.train(loop.TrainConfig(
            preset=preset, dataset="", steps=TRAIN_STEPS, batch_size=batch,
            lr=lr, warmup=2, min_lr=lr / 10, weight_decay=0.1,
            dtype="bfloat16", log_every=1, ckpt_every=0, workdir=wd,
            mesh=rspec, device=dev, prefetch=0, optimizer=optimizer,
            **fields))
        if cuda:
            torch.cuda.synchronize()
        row.update(counts=read_counts(), band_hops=dict(band),
                   plain_on_card=[PLAIN_ON_CARD["fwd"], PLAIN_ON_CARD["bwd"]],
                   peak=torch.cuda.max_memory_allocated() if cuda else 0,
                   wall=time.perf_counter() - t0,
                   final_loss=summary["final_loss"])
        if rank == 0:
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                row["recs"] = [json.loads(line) for line in f]
        res["runs"].append(row)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def _run_cfg(preset, fields):
    from vitrs_tpu_torch.config import get_config
    return get_config(preset, dtype="bfloat16",
                      num_kv_heads=fields.get("kv_heads", 0),
                      **fields.get("model_overrides", {}))


def _designed_cp_ep(name, rank, S=TRAIN_STEPS):
    """(launches, cut hops (fwd, bwd)) a rank makes over S steps of a
    full-width run of L = MESH_LAYERS layers: under cp every rank runs its
    diagonal hop, rank 1 its past hop too (K1-fwd / K2 at cp-4k; at
    cp-window the band cuts it, so K3-fwd / K3-bwd on the rectangle the
    band reaches: L forward and L backward cut hops a step, 2L K3 launches
    each way on rank 1, L on rank 0); K5 and K6 once a step; K7 once a step
    on cp's ZeRO-1 shard; ep and ep x tp K1-fwd and K2 once a layer (NH=12
    and 6), no K7."""
    L = MESH_LAYERS
    # every rank runs its layers' MLP once a step, whatever its hops
    ce = dict(ce_fwd=S, ce_bwd=S, gelu_fwd=L * S, gelu_bwd=L * S)
    if name == "cp-4k":
        return designed(flash_fwd=L * S * (1 + rank),
                        flash_bwd=L * S * (1 + rank), adamw=S, **ce), [0, 0]
    if name == "cp-window":
        return (designed(flash_gqa_fwd=L * S * (1 + rank),
                         flash_gqa_bwd=L * S * (1 + rank), **ce),
                [L * S * rank] * 2)
    return designed(flash_fwd=L * S, flash_bwd=L * S, **ce), [0, 0]


def phase_meshes_cp_ep(smi, dev="cuda:0"):
    """CP_EP_RUNS: ranks that share cuda:0 over gloo (every collective, ring
    hop and all-to-all staged through host memory) run (a) one step of the
    small fp32 model (D=64, so the kernels) under cp=2 (AdamW dense and
    banded, Adafactor), ep=2 and ep=2,tp=2 (AdamW, Adafactor), held
    against one process stepping the whole batch (`_cp_ep_reference`) at
    the CPU tests' tolerances: loss rtol 2e-5; params AdamW rtol 2e-4 atol
    5e-5, Adafactor rtol 1e-4 atol 2e-4, a value whose gradient is fp32
    noise within lr; (b) at full width (4 of the presets' 12 layers,
    MESH_LAYERS) through train/loop.train,
    6 steps: gpt2-124m-4k (B=4, AdamW) and the train-window model (rope +
    W=1024, 4 kv heads, T=8192, B=2, Adafactor: the banded ring) under
    cp=2, gpt2-moe-8e (B=8) under ep=2 (AdamW, clip 1.0) and ep=2,tp=2
    (Adafactor): first the mesh's fp32 gradient of the first batch against
    one process's (`_full_width_grads`; at initialisation the loss is
    about ln V whatever the attention or the routing computes, the
    gradient is not): loss rtol 1e-5; every leaf's gradient within 1e-4 of
    its L2 norm under cp (summation order alone: about 1e-6) and 2e-2
    under ep (a token whose top-2 sits on an fp32 tie may route elsewhere
    in one of the two, which would move its experts' and the router's
    gradients by a few 1e-3; in bf16 many do, hence fp32), where a ring
    hop or an expert block gone wrong (even a past hop's dk scaled by 0.9)
    lands well past the bound; then each rank's loss equal, step 1's the
    one-process bf16 loss (rtol 1e-3), falling; each rank's launches and
    cut hops as designed (`_designed_cp_ep`), no flash plain version
    called on CUDA tensors (`_watch_plain`); its parameter +
    state bytes as its slicing predicts; its peak; step ms (time-sliced on
    one card: not a scaling number)."""
    device = torch.device(dev)
    ref = _cp_ep_reference(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res = {}
    for world, small, runs in CP_EP_RUNS:
        ranks, _, wall = _mesh_run(runs[0][2], world, target=_cp_ep_rank,
                                   dev=dev, small=small, runs=runs)
        for sspec, optimizer, variant in small:
            tag = f"[meshes-cp-ep {sspec}]"
            lref, gref, steps = ref[variant]
            layout = ("cp" if sspec.startswith("cp") else "eptp"
                      if "tp" in sspec and optimizer == "adafactor" else "ep")
            worst = 0.0
            for r, out in enumerate(ranks):
                got = out["small"][(sspec, optimizer, variant)]
                check(abs(got["loss"] - lref) <= 2e-5 * abs(lref),
                      f"{tag} small {variant} {optimizer} rank {r} loss "
                      f"{got['loss']} vs one process {lref}")
                rtol, atol = {"adamw": (2e-4, 5e-5),
                              "adafactor": (1e-4, 2e-4)}[optimizer]
                worst = max(worst, _hold(
                    f"{tag} small {variant} {optimizer} rank {r}",
                    got["params"], steps[(optimizer, layout)], rtol, atol,
                    gref, SMALL_LR[optimizer][0]))
            res[f"small {sspec} {optimizer} {variant}"] = dict(
                world=world, loss=lref, param_err=worst)
            print(f"{tag} small fp32 step, {variant}, {optimizer}: loss "
                  f"{lref:.6f} as one process on every rank; params max err "
                  f"{worst:.3e}")
        for i, (name, preset, spec, batch, optimizer, fields) in enumerate(
                runs):
            tag = f"[meshes-cp-ep {name} {spec}]"
            outs = [o["runs"][i] for o in ranks]
            for r, out in enumerate(outs):
                want, band = _designed_cp_ep(name, r)
                check(out["counts"] == want,
                      f"{tag} rank {r} launches {out['counts']} != {want}")
                hops = [out["band_hops"]["fwd"], out["band_hops"]["bwd"]]
                check(hops == band, f"{tag} rank {r} cut hops (on the "
                      f"kernels' rectangle) {hops} != {band}")
                check(out["plain_on_card"] == [0, 0], f"{tag} rank {r} ran "
                      f"a flash plain version on the card (fwd, bwd) "
                      f"{out['plain_on_card']} times")
                h, pred = out["state_bytes"]
                check(h == pred, f"{tag} rank {r} state bytes {h} != "
                      f"predicted {pred}")
            finals = {o["final_loss"] for o in outs}
            check(len(finals) == 1, f"{tag} ranks' losses differ: {finals}")
            recs = outs[0]["recs"]
            losses = [rec["loss"] for rec in recs]
            check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
                  and losses[-1] < losses[0], f"{tag} losses {losses}")
            mloss, one32, gerr, one = outs[0]["grads"]
            worst = max(gerr, key=gerr.get)
            gtol = 2e-2 if name.startswith("ep") else 1e-4
            check(abs(mloss - one32) <= 1e-5 * abs(one32),
                  f"{tag} first-batch fp32 loss {mloss} vs one process "
                  f"{one32}")
            check(gerr[worst] <= gtol, f"{tag} first-batch fp32 gradient "
                  f"of {worst}: relative L2 error {gerr[worst]:.3e} "
                  f"against one process (bound {gtol}); every leaf {gerr}")
            check(abs(losses[0] - one) <= 1e-3 * abs(one),
                  f"{tag} step-1 loss {losses[0]} vs one process {one}")
            # from tok/s: the log rounds images/s to 0.1, too coarse here
            T = _run_cfg(preset, fields).seq_len
            tok_s = float(np.median([rec["tok_per_sec"] for rec in recs[2:]]))
            step_ms = batch * T / tok_s * 1e3
            row = dict(world=world, kind=outs[0]["kind"],
                       route=ranks[0]["route"], losses=losses,
                       one_process_step1_loss=one,
                       first_batch_fp32_loss=[mloss, one32],
                       grad_rel_err=gerr, grad_bound=gtol, step_ms=step_ms,
                       launches_per_step=[{k: v // TRAIN_STEPS for k, v in
                                           o["counts"].items() if v}
                                          for o in outs],
                       cut_hops=[[o["band_hops"]["fwd"],
                                  o["band_hops"]["bwd"]] for o in outs],
                       plain_on_card=[o["plain_on_card"] for o in outs],
                       state_bytes=[o["state_bytes"][0] for o in outs],
                       peak_gib=[o["peak"] / 2**30 for o in outs],
                       run_wall_s=[o["wall"] for o in outs],
                       spawn_wall_s=wall)
            res[name] = row
            print(f"{tag} {preset} B={batch} {optimizer} {TRAIN_STEPS} "
                  f"steps, {world} ranks on {dev} over {row['route']}: loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f} (every rank; step 1 "
                  f"in one process {one:.4f}); first-batch fp32 gradient "
                  f"vs one process: worst leaf {worst} {gerr[worst]:.3e} "
                  f"(L2, relative, bound {gtol}; median leaf "
                  f"{float(np.median(list(gerr.values()))):.3e}); "
                  f"launches a step per rank "
                  f"{row['launches_per_step']} (as designed), cut hops on "
                  f"the kernels per rank {row['cut_hops']}, plain versions "
                  f"on the card per rank {row['plain_on_card']}; parameter + "
                  f"state bytes a rank {row['state_bytes']} (as predicted); "
                  f"peak a rank {[round(x, 3) for x in row['peak_gib']]} "
                  f"GiB; {step_ms:.1f} ms a step (ranks time-sliced on one "
                  f"card, not a scaling number); the spawn's wall "
                  f"{wall:.1f} s  ({smi})")
    return res


# ---------------------------------------------------------------------------
# Head dims 32, 128 and 256, then the ends 8, 16, 384 and 512: the flash
# libraries built once per head dim (ops/_build.load(name, D); one D = 16
# build serves every D <= 16), at GPT-2 124M's width C = 768 (D = 512 at
# gpt2-350m's C = 1024)
# ---------------------------------------------------------------------------

HD_NEW = (32, 128, 256)
HD_ENDS = (8, 16, 384, 512)
HD_EDGE_ONLY = (1, 2, 4)      # the D = 16 build's other head dims: edge rows
# the largest admitted head dim and the odd atom count (ten 64-column
# atoms, five 128-column slices): checked, not timed (no model path)
HD_CHECK_ONLY = (640, 1024)
# heads of D at C = 768 (1024 at D = 512, 1280 at 640, 2048 at 1024); D =
# 1, 2, 4 at 16 heads
HD_HEADS = {32: 24, 128: 6, 256: 3, 8: 96, 16: 48, 384: 2, 512: 2,
            1: 16, 2: 16, 4: 16, 640: 2, 1024: 2}
HD_KV = {32: 8, 128: 2, 256: 1, 8: 8, 16: 8, 384: 1, 512: 1,
         1: 4, 2: 4, 4: 4, 640: 1, 1024: 1}    # the K3 rows' kv heads
# each kernels-head-dims case draws from its own generator, seeded from
# HD_SEED and the case's parameters (`hd_gen`); bwd-seeds draws D = 32's
# rope case at seeds 0 .. HD_SEEDS - 1
HD_SEED, HD_SEEDS = 17, 12
HD_PRESET = {512: "gpt2-350m"}                 # else gpt2-124m
# the rope + W=1024, T=8192 kernel rows (the GQA window model's shape)
HD_ROPE_T8K = (32, 128, 16)
# parameters of the models the head-dim phases train: the MHA model at
# each D, and its GQA variant (the window model at D = 16 and 128)
HD_PARAMS = {d: 124_439_808 for d in (8, 16, 32, 128, 256, 384)}
HD_PARAMS[512] = 354_823_168
HD_GQA_PARAMS = {8: 111_446_784, 16: 118_132_992, 32: 114_990_336,
                 256: 114_990_336, 384: 117_352_704, 512: 329_632_768}
# GPT-2 124M with 2 kv heads of 128, rope, W=1024 at T=8192: the q/k/v
# projection at kv width 256 (as 4 kv heads of 64) and 7,168 more wpe rows
HD_GQA_WINDOW_PARAMS = 120_495_360
# the chunked generates: prompt and chunk length; K4 runs each chunk after
# the first.  Per head dim, each generate's (dtype, batch, kv heads, new
# tokens): serve-d128's bf16 and fp32 ones (the MHA model), train-d32's and
# train-d256's (the GQA models)
HD_PROMPT, HD_CHUNK = 768, 256
HD_K4_PATHS = {128: (("bfloat16", 8, 6, 1), ("float32", 2, 6, 32)),
               32: (("bfloat16", 2, 8, 8),), 256: (("bfloat16", 2, 1, 8),),
               8: (("bfloat16", 8, 96, 1), ("float32", 2, 96, 32)),
               16: (("bfloat16", 2, 8, 8),), 384: (("bfloat16", 2, 1, 8),),
               512: (("bfloat16", 2, 1, 8),)}


def hd_gen(*case, seed=HD_SEED):
    """A generator on the card seeded from `seed` and a case's parameters,
    so that a case draws the same inputs whatever runs before it."""
    return torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr((seed,) + case).encode()))


def bwd_term_norms(q, k, v, out, lse, do, num_heads, kv_heads, causal,
                   sm_scale, window=0, rope=False, q_offset=0):
    """For each element of (dq, dk, dv), the L2 norm of the terms of its
    sum as `flash_gqa_bwd_plain` (same arguments) forms them (dq[i, c] = sum_j ds[i, j] k[j, c],
    dk[j, c] = sum over the group's heads and i of ds[i, j] q[i, c],
    dv[j, c] = sum of p[i, j] do[i, c], p and ds rounded to the input
    type), fp32, laid out as the gradients.  Where the kernel and the plain
    version round one p or ds from fp32 values a few ulps apart (the
    kernel's ex2.approx, its own summation order) to neighbouring bf16
    values, the element moves by one bf16 ulp of that term, at most 2^-7
    of it, so at most 2^-7 of this norm: `hd_check_bwd` passes this as
    `grad_errors`' `parts`.  Under rope, dq and dk are rotated back
    pairwise, so each column of a pair takes the pair's norm."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    B, Tq, _ = q.shape
    keys = k.shape[1]
    KH = kv_heads or num_heads
    R = num_heads // KH
    dtype = q.dtype
    if causal:
        k, v = k[:, :q_offset + Tq], v[:, :q_offset + Tq]
    Tk = k.shape[1]
    qf = FA._grouped(FA._rotated(q, num_heads, q_offset, rope), num_heads, R)
    kf = FA._grouped(FA._rotated(k, KH, 0, rope), KH, 1)
    dof, vf = FA._grouped(do, num_heads, R), FA._grouped(v, KH, 1)
    if FA.scale_in_fp32(sm_scale):
        s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    else:
        s = torch.matmul((qf * sm_scale).to(dtype).float(),
                         kf.transpose(-1, -2))
    p = torch.exp(s - lse.reshape(B, KH, R, Tq)[..., None])
    del s
    if causal:
        p = p.masked_fill(FA._hidden(Tq, Tk, q_offset, window, q.device), 0.0)
    di = (FA._grouped(out, num_heads, R) * dof).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di) * sm_scale
    p2, ds2 = (t.to(dtype).float().square() for t in (p, ds))
    del p, ds
    dv = torch.matmul(p2.transpose(-1, -2), dof.square()).sum(dim=2)
    dk = torch.matmul(ds2.transpose(-1, -2), qf.square()).sum(dim=2)
    dq = torch.matmul(ds2, kf.square()).flatten(1, 2)

    def packed(t, pairs):      # (B, heads, T, D) squares -> (B, T, W) norms
        if pairs:
            h = t.shape[-1] // 2
            t = (t[..., :h] + t[..., h:]).repeat(1, 1, 1, 2)
        n = t.shape[2]
        return t.transpose(1, 2).reshape(B, n, -1).sqrt()

    dk, dv = packed(dk, rope), packed(dv, False)
    if Tk < keys:
        dk, dv = (torch.nn.functional.pad(t, (0, 0, 0, keys - Tk))
                  for t in (dk, dv))
    return packed(dq, rope), dk, dv


def hd_cache_len(new):
    """The cache a chunked generate of HD_PROMPT + `new` tokens allocates
    (models/generate.py: rounded up to PREFILL_BLOCK)."""
    from vitrs_tpu_torch.ops.flash_prefill import PREFILL_BLOCK
    return -(-(HD_PROMPT + new) // PREFILL_BLOCK) * PREFILL_BLOCK


def hd_plain(fn, groups, q, k, v, nh, kh, *rest, **kw):
    """A flash plain version (fwd: rest empty; bwd: rest = out, lse, do)
    over `groups` slices of whole kv heads and their query heads, the
    results concatenated: the plain versions build (B, heads, Tq, Tk) fp32
    tensors, which past T = 4096 at 24 heads outgrow the card."""
    d = q.shape[-1] // nh
    hq, hk = nh // groups, kh // groups
    outs = []
    for g in range(groups):
        def cut(t, n):
            return t[..., g * n * d:(g + 1) * n * d]
        args = [cut(q, hq), cut(k, hk), cut(v, hk)]
        if rest:
            out, lse, do = rest
            args += [cut(out, hq), lse[:, g * hq:(g + 1) * hq], cut(do, hq)]
        outs.append(fn(*args, hq, kv_heads=hk, **kw))
    dims = (-1, 1) if not rest else (-1, -1, -1)
    return tuple(torch.cat(list(parts), dim=dm)
                 for parts, dm in zip(zip(*outs), dims))


def hd_resources(d, rope=False, band=False):
    """{kernel: registers, spill bytes, shared memory, threads} of the bf16
    flash kernels built for head dim d (vitrs_flash_fwd_attrs /
    vitrs_flash_bwd_attrs of the d library, at sm_scale 1/sqrt(d)); fails
    on a spill in the forward."""
    import ctypes
    from vitrs_tpu_torch.ops import _build
    from vitrs_tpu_torch.ops.flash_attention import build_dim, scale_in_fp32
    qhat = int(not scale_in_fp32(1.0 / math.sqrt(d)))
    res = {}
    for lib, kernels, flag in (
            ("flash_fwd", ((1, "fwd"), (0, "fwd_rope_k")), int(band)),
            ("flash_bwd", ((0, "bwd_prep"), (1, "bwd_dkv"), (2, "bwd_dq")),
             qhat)):
        fn = getattr(_build.load(lib, build_dim(d)).lib, f"vitrs_{lib}_attrs")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for i, name in kernels:
            # D <= 16 rotates k as it stages it: no pre-pass
            if name == "fwd_rope_k" and (not rope or d <= 16):
                continue
            out = (ctypes.c_int * 5)()
            rc = fn(i, int(rope), flag, ctypes.cast(out, ctypes.c_void_p))
            check(rc == 0, f"{lib} D={d} attrs({name}): CUDA error {rc}")
            res[name] = dict(registers=out[0], spill_bytes=out[1],
                             smem_bytes=out[2] + out[3], threads=out[4])
            if lib == "flash_fwd":
                check(out[1] == 0, f"flash forward D={d} {name} spills "
                      f"{out[1]} bytes a thread")
    return res


def hd_check_fwd(where, got, want, rel_lse=False):
    """A forward (out, lse) against its plain version: out as `out_errors`,
    lse 1e-4 bf16 / 1e-5 fp32 (relative to max(1, |lse|) with rel_lse),
    rows that see no key equal (lse -inf, out 0).  In bf16 prints out's
    share of the bound and what the tensor's rms alone would reject, at
    T = 8192 (rel_lse) always, else where over 0.9 or any.  Returns
    max_abs_err."""
    (out, lse), (ref, ref_lse) = got, want
    check(torch.isfinite(out).all().item(), f"{where}: out non-finite")
    bad, err, _ = out_errors(out, ref)
    check(bad == 0, f"{where}: {bad} out values beyond tolerance "
          f"(max_abs_err {err:.3e})")
    if out.dtype == torch.bfloat16:
        share, flat = out_share(out, ref), out_errors(out, ref, rows=False)[0]
        if rel_lse or share > 0.9 or flat:
            head = where.split()[0]
            print(f"[{head}] {where[len(head) + 1:]}: out at {share:.3f} of "
                  f"`out_errors`' bound; the tensor's rms alone would "
                  f"reject {flat}")
    dead = torch.isinf(ref_lse)
    check(torch.equal(torch.isinf(lse), dead), f"{where}: rows that see no "
          f"key differ")
    live = ~dead
    d = (lse - ref_lse).abs()[live]
    if rel_lse:
        d = d / ref_lse.abs()[live].clamp_min(1.0)
    lerr = d.max().item() if d.numel() else 0.0
    tol = 1e-4 if out.dtype == torch.bfloat16 else 1e-5
    check(lerr <= tol, f"{where}: lse err {lerr} > {tol}")
    return err


def hd_check_bwd(where, got, want, terms, rms_bound=True):
    """(dq, dk, dv) against the plain version: in bf16 2e-2 abs + rel (p
    and ds round to bf16 against the kernel's and the plain version's fp32
    values, which differ in their last bits) and, with rms_bound,
    `grad_errors`' bound, which follows the tensor's rms (not where a
    single key makes dq = ds k cancellation noise: T = 1), widened by 2^-7
    of the L2 norm of each element's terms (`bwd_term_norms`, from
    `terms()`, called only where a value is past the rms bound alone): one
    term that the two round to neighbouring bf16 values, where one large p
    or ds dominates an element (a key that early rows weigh near 1); in
    fp32 1e-4 abs + rel, as every K2 check.  Returns max_abs_err."""
    bf16 = got[0].dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 1e-4
    worst, norms = 0.0, None
    for i, (name, a, b) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{where}: {name} "
              f"{tuple(a.shape)} {a.dtype}")
        d = (a.float() - b.float()).abs()
        bad = ((d > tol + tol * b.float().abs()).sum().item()
               + (~torch.isfinite(a)).sum().item())
        check(bad == 0, f"{where}: {bad} {name} values beyond {tol}")
        if bf16 and rms_bound:
            bad, err, rms = grad_errors(a, b)
            if bad:
                norms = terms() if norms is None else norms
                past = bad
                bad, err, rms = grad_errors(a, b, norms[i])
                print(f"[{where.split()[0]}] {where.split(' ', 1)[1]}: "
                      f"{past} {name} values past the rms bound alone, "
                      f"{bad} past it with the one-term allowance "
                      f"(max_abs_err {err:.3e}, rms {rms:.3e})")
            check(bad == 0, f"{where}: {bad} {name} values beyond "
                  f"grad_errors' bound (max_abs_err {err:.3e}, rms {rms:.3e})")
        worst = max(worst, d.max().item())
    return worst


def hd_timed(tag, what, kernel, plain, library, nkernels, flops, bnd,
             plain_iters=None):
    """Times a kernel at its shape: events (`timed_pair`), the profiler's
    device time (`nkernels` kernels a call), the library call; prints and
    returns the kernels-line numbers."""
    _, _, (k1, k2, p1, p2) = timed_pair(kernel, plain,
                                        plain_iters=plain_iters)
    dev, caps = device_ms(kernel, nkernels)
    lib = cuda_ms(library) if library is not None else None
    km = dev if dev is not None else (k1 + k2) / 2
    bms, by = bnd
    print(f"[{tag}] {what}: kernel {k1:.4f}/{k2:.4f} ms by events, "
          f"{dev if dev is None else round(dev, 4)} ms device (capture "
          f"{caps}); plain {p1:.4f}/{p2:.4f} ms; library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}; bound {bms:.4f} ms "
          f"({by}), {bms / km:.1%} of it, {flops / km / 1e9:.1f} TFLOP/s")
    return dict(ms=km, ms_events=[k1, k2], device_ms=dev, plain_ms=(p1 + p2) / 2,
                library_ms=lib, bound_ms=bms, bound_by=by,
                tflops=flops / km / 1e9)


def phase_kernels_head_dims():
    """K1-fwd, K2, K3-fwd / K3-bwd and K4 at head dims 32, 128 and 256
    (24, 6 and 3 heads at C = 768; K3 at 8, 2 and 1 kv heads) against
    their plain versions: the edge rows (T = 1, 37, 200; MHA and GQA,
    causal and full, bf16 and fp32, every call twice and bitwise equal);
    the square B=8 T=1024 causal and the ViT shape B=64 T=197 non-causal;
    rope + W=1024 at B=2 T=8192 (D = 32, 128); K4 (edge chunks S = 1, 37,
    200 in bf16 and fp32; every chunk that the chunked generates of
    serve-d128 and train-d32 / train-d256 give it, at HD_K4_PATHS; S=512
    at q_offset 7168; NaN cache tails); at D = 128 the ring's cut hop (queries past the keys'
    end) and rows that see no key.  Then each kernel's time beside its
    plain version, SDPA and the bound, and its registers and shared
    memory.  Tolerances as `hd_check_fwd` / `hd_check_bwd`."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}

    def inputs(B, T, nh, kh, d, dtype, tk=None, *case):
        """q, k, v, do of one case, from its own generator (`hd_gen`)"""
        gen = hd_gen(B, T, nh, kh, d, str(dtype), tk, *case)
        q, do = (torch.randn(B, T, nh * d, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, tk or T, kh * d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        return q, k, v, do

    def terms(q, k, v, out, lse, do, nh, kh, *a):
        return lambda: bwd_term_norms(q, k, v, out, lse, do, nh, kh, *a)

    def fwd(q, k, v, nh, kh, *a):
        if kh == nh:
            return FA.flash_fwd_cuda(q, k, v, nh, *a)
        return FG.flash_gqa_fwd_cuda(q, k, v, nh, kh, *a)

    def bwd(q, k, v, out, lse, do, nh, kh, *a):
        if kh == nh:
            return FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, *a)
        return FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, nh, kh, *a)

    def edges(d, nh, kv, tag):
        """The edge rows: one tile, a ragged one, several; both widths,
        causal and full, bf16 and fp32, each call twice; at an even D <=
        16 also rope + a band (W=33, T=150), which those head dims rotate
        as they stage q and k.  Returns the worst errors."""
        sm = 1.0 / math.sqrt(d)
        worst = {"fwd": 0.0, "bwd": 0.0}
        n = 0
        cases = [(T, causal, 0, False) for T in (1, 37, 200)
                 for causal in (True, False)]
        if d <= 16 and d % 2 == 0:
            cases.append((150, True, 33, True))
        for dtype in (bf16, f32):
            for T, causal, W, rope in cases:
                for kh in (nh, kv):
                    q, k, v, do = inputs(2, T, nh, kh, d, dtype, None, causal)
                    a = (causal, sm) + ((W, rope) if rope else ())
                    got, again = fwd(q, k, v, nh, kh, *a), fwd(q, k, v, nh, kh, *a)
                    want = FG.flash_gqa_fwd_plain(q, k, v, nh, kh, *a)
                    g = bwd(q, k, v, *got, do, nh, kh, *a)
                    g2 = bwd(q, k, v, *got, do, nh, kh, *a)
                    gw = FG.flash_gqa_bwd_plain(q, k, v, *got, do, nh, kh, *a)
                    torch.cuda.synchronize()
                    where = (f"{tag} {str(dtype)[6:]} T={T} KH={kh} "
                             f"causal={int(causal)}"
                             + (f" rope W={W}" if rope else ""))
                    check(all(torch.equal(x, y) for x, y in
                              zip((*got, *g), (*again, *g2))),
                          f"{where}: two calls differ")
                    worst["fwd"] = max(worst["fwd"], hd_check_fwd(
                        where, got, want))
                    worst["bwd"] = max(worst["bwd"], hd_check_bwd(
                        where, g, gw, terms(q, k, v, *got, do, nh, kh, *a),
                        rms_bound=T > 1))
                    n += 1
        print(f"[{tag}] {n} edge cases (T 1/37/200, KH {nh}/{kv}, causal "
              f"and full, bf16 and fp32"
              + (", rope + W=33 at T=150" if len(cases) > 6 else "")
              + f") within tolerance: forward max_abs_err "
              f"{worst['fwd']:.3e}, backward {worst['bwd']:.3e}; each twice, "
              f"bitwise equal")
        return worst

    def k4_edges(d, nh, kv, tag):
        """K4's edge rows: chunks off the 64 grid, one row, a cache tail
        of NaN past the chunk's frontier; bf16 and fp32."""
        sm = 1.0 / math.sqrt(d)
        n, worst = 0, 0.0
        for dtype in (bf16, f32):
            for S, q_off, Tk in ((1, 517, 768), (37, 100, 256), (200, 133, 512)):
                q, k, v, _ = inputs(2, S, nh, kv, d, dtype, Tk, q_off)
                k[:, q_off + S:] = float("nan")
                v[:, q_off + S:] = float("nan")
                got = FP.flash_prefill_qkv(q, k, v, nh, kv, q_off)
                want = FP.flash_prefill_plain(q, k, v, nh, kv, q_off, sm)
                torch.cuda.synchronize()
                where = (f"{tag} {str(dtype)[6:]} K4 S={S} q_offset={q_off} "
                         f"cache {Tk} KH={kv}")
                check(torch.isfinite(got).all().item(), f"{where}: non-finite")
                bad, err, _ = out_errors(got, want)
                check(bad == 0, f"{where}: {bad} values beyond tolerance")
                worst = max(worst, err)
                n += 1
        print(f"[{tag}] K4: {n} edge chunks (S 1/37/200 off the 64 grid, "
              f"NaN cache tails, bf16 and fp32) within tolerance "
              f"(max_abs_err {worst:.3e})")
        return worst

    for d in HD_NEW + HD_ENDS:
        nh, kv, sm = HD_HEADS[d], HD_KV[d], 1.0 / math.sqrt(d)
        tag = f"kernels-d{d}"
        r = {}
        worst = edges(d, nh, kv, tag)

        # the square path, MHA and GQA, bf16: checked, then timed
        for kh, kf, kb in ((nh, "flash_fwd", "flash_bwd"),
                           (kv, "flash_gqa_fwd", "flash_gqa_bwd")):
            B, T = 8, 1024
            q, k, v, do = inputs(B, T, nh, kh, d, bf16)
            got = fwd(q, k, v, nh, kh, True, sm)
            want = FG.flash_gqa_fwd_plain(q, k, v, nh, kh, True, sm)
            g = bwd(q, k, v, *got, do, nh, kh, True, sm)
            g2 = bwd(q, k, v, *got, do, nh, kh, True, sm)
            gw = FG.flash_gqa_bwd_plain(q, k, v, *got, do, nh, kh, True, sm)
            torch.cuda.synchronize()
            where = f"{tag} bf16 B={B} T={T} NH={nh} KH={kh} causal"
            ef = hd_check_fwd(where, got, want)
            check(all(torch.equal(x, y) for x, y in zip(g, g2)),
                  f"{where}: backward differs between two calls")
            eb = hd_check_bwd(where, g, gw, terms(q, k, v, *got, do, nh, kh,
                                                  True, sm))
            flops, bnd = fwd_bound(B, nh, kh, d, T, 0, T, 2)
            r[kf] = dict(max_abs_err=max(ef, worst["fwd"]), shape=where[len(tag) + 1:],
                         **hd_timed(tag, f"{kf} {where}", lambda: fwd(
                             q, k, v, nh, kh, True, sm), lambda: FG.flash_gqa_fwd_plain(
                             q, k, v, nh, kh, True, sm), lambda: sdpa(
                             q, k, v, nh, kh), 1, flops, bnd,
                             plain_iters=None if d in HD_NEW else 3))
            out, lse = got
            flops, bnd = bwd_bound(B, nh, kh, d, T, 2)
            r[kb] = dict(max_abs_err=max(eb, worst["bwd"]), shape=where[len(tag) + 1:],
                         **hd_timed(tag, f"{kb} {where}", lambda: bwd(
                             q, k, v, out, lse, do, nh, kh, True, sm),
                             lambda: FG.flash_gqa_bwd_plain(
                                 q, k, v, out, lse, do, nh, kh, True, sm),
                             sdpa_bwd(q, k, v, do, nh, kh), 3, flops, bnd,
                             plain_iters=None if d in HD_NEW else 3))
            # one exp a visible pair, forward and backward: the function's
            # own least (this backward recomputes p in both its dK/dV and
            # its dQ kernel, two a pair, a cost of the design)
            if d <= 16:
                pairs = B * nh * attn_pairs(T, 0, T, True)
                r[kf]["ex2_bound_ms"] = r[kb]["ex2_bound_ms"] = (
                    pairs / EX2_PER_S * 1e3)
                print(f"[{tag}] {kf} / {kb} NH={nh} KH={kh}: exp bound "
                      f"{r[kf]['ex2_bound_ms']:.4f} / "
                      f"{r[kb]['ex2_bound_ms']:.4f} ms ({pairs} pairs at "
                      f"{EX2_PER_S:.4g} exps a second): "
                      f"{r[kf]['ex2_bound_ms'] / r[kf]['ms']:.1%} / "
                      f"{r[kb]['ex2_bound_ms'] / r[kb]['ms']:.1%} of it")
            del q, k, v, do, got, want, g, g2, gw, out, lse

        # the ViT shape, non-causal, MHA (head dims a ViT preset has)
        if d in HD_NEW:
            B, T = 64, 197
            q, k, v, do = inputs(B, T, nh, nh, d, bf16)
            got = FA.flash_fwd_cuda(q, k, v, nh, False, sm)
            g = FA.flash_bwd_cuda(q, k, v, *got, do, nh, False, sm)
            want = FA.flash_fwd_plain(q, k, v, nh, False, sm)
            gw = FA.flash_bwd_plain(q, k, v, *got, do, nh, False, sm)
            torch.cuda.synchronize()
            where = f"{tag} bf16 B={B} T={T} NH={nh} non-causal"
            ef = hd_check_fwd(where, got, want)
            eb = hd_check_bwd(where, g, gw, terms(q, k, v, *got, do, nh, nh,
                                                  False, sm))
            out, lse = got
            flops, bnd = fwd_bound(B, nh, nh, d, T, 0, T, 2, causal=False)
            r["flash_fwd"]["vit"] = dict(max_abs_err=ef, **hd_timed(
                tag, f"flash_fwd {where}",
                lambda: FA.flash_fwd_cuda(q, k, v, nh, False, sm),
                lambda: FA.flash_fwd_plain(q, k, v, nh, False, sm),
                lambda: sdpa(q, k, v, nh, nh, causal=False), 1, flops, bnd))
            flops, bnd = bwd_bound(B, nh, nh, d, T, 2, causal=False)
            r["flash_bwd"]["vit"] = dict(max_abs_err=eb, **hd_timed(
                tag, f"flash_bwd {where}",
                lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, False, sm),
                lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, nh, False, sm),
                sdpa_bwd(q, k, v, do, nh, nh, causal=False), 3, flops, bnd))
            del q, k, v, do, got, g, want, gw, out, lse

        # rope + the band at T=8192 (the train-window model's shape)
        if d in HD_ROPE_T8K:
            B, T, W = 2, 8192, 1024
            groups = nh // 6
            mask = band_mask(T, 0, T, W)
            for kh, kf, kb in ((nh, "flash_fwd", "flash_bwd"),
                               (kv, "flash_gqa_fwd", "flash_gqa_bwd")):
                q, k, v, do = inputs(B, T, nh, kh, d, bf16)
                a = (True, sm, W, True)
                got = fwd(q, k, v, nh, kh, *a)
                g = bwd(q, k, v, *got, do, nh, kh, *a)
                pw = dict(window=W, rope=True)
                want = hd_plain(FA.flash_fwd_plain, groups, q, k, v, nh, kh,
                                causal=True, sm_scale=sm, **pw)
                gw = hd_plain(FA.flash_bwd_plain, groups, q, k, v, nh, kh,
                              *got, do, causal=True, sm_scale=sm, **pw)
                torch.cuda.synchronize()
                where = f"{tag} bf16 B={B} T={T} NH={nh} KH={kh} rope W={W}"
                ef = hd_check_fwd(where, got, want, rel_lse=True)
                eb = hd_check_bwd(where, g, gw, lambda: hd_plain(
                    bwd_term_norms, groups, q, k, v, nh, kh, *got, do,
                    causal=True, sm_scale=sm, **pw))
                del want, gw
                out, lse = got
                qr = FA._rotated(q, nh, 0, True)
                kr = FA._rotated(k, kh, 0, True)
                flops, bnd = fwd_bound(B, nh, kh, d, T, 0, T, 2,
                                       window=W, rope=True)
                r[kf]["rope_window"] = dict(max_abs_err=ef, **hd_timed(
                    tag, f"{kf} {where}", lambda: fwd(q, k, v, nh, kh, *a),
                    lambda: hd_plain(FA.flash_fwd_plain, groups, q, k, v, nh,
                                     kh, causal=True, sm_scale=sm, **pw),
                    lambda: sdpa(qr, kr, v, nh, kh, mask=mask),
                    2 if d > 16 else 1, flops, bnd, plain_iters=2))
                flops, bnd = bwd_bound(B, nh, kh, d, T, 2, window=W,
                                       rope=True)
                r[kb]["rope_window"] = dict(max_abs_err=eb, **hd_timed(
                    tag, f"{kb} {where}",
                    lambda: bwd(q, k, v, out, lse, do, nh, kh, *a),
                    lambda: hd_plain(FA.flash_bwd_plain, groups, q, k, v, nh,
                                     kh, out, lse, do, causal=True,
                                     sm_scale=sm, **pw),
                    sdpa_bwd(qr, kr, v, do, nh, kh, mask=mask), 3, flops,
                    bnd, plain_iters=2))
                del q, k, v, do, got, g, out, lse, qr, kr
            del mask
            torch.cuda.empty_cache()

        # K4's edge rows
        k4_edges(d, nh, kv, tag)

        # K4 at its main path's geometry (every continuation chunk of the
        # chunked generates of serve-d128 and train-d32 / train-d256, at
        # their batch, kv heads and cache length; the bf16 last chunk timed,
        # the kernels-line row's numbers), then the last 512-token chunk of
        # an 8K prompt (the row's `long_context`)
        checked, timed = [], {}
        cases = [(getattr(torch, dname), B, kh, HD_CHUNK, q_off,
                  hd_cache_len(new), dname == "bfloat16"
                  and q_off == HD_PROMPT - HD_CHUNK)
                 for dname, B, kh, new in HD_K4_PATHS[d]
                 for q_off in range(HD_CHUNK, HD_PROMPT, HD_CHUNK)]
        n_path = len(cases)
        if d in HD_NEW:
            cases.append((bf16, 8, kv, 512, 7168, 7936, True))
        for dtype, B, kh, S, q_off, Tk, time_it in cases:
            q, k, v, _ = inputs(B, S, nh, kh, d, dtype, Tk, q_off)
            k[:, q_off + S:] = float("nan")
            v[:, q_off + S:] = float("nan")
            got = FP.flash_prefill_qkv(q, k, v, nh, kh, q_off)
            again = FP.flash_prefill_qkv(q, k, v, nh, kh, q_off)
            want = FP.flash_prefill_plain(q, k, v, nh, kh, q_off, sm)
            torch.cuda.synchronize()
            where = (f"{tag} {str(dtype)[6:]} K4 B={B} S={S} q_offset={q_off}"
                     f" cache {Tk} KH={kh}")
            check(torch.isfinite(got).all().item() and torch.equal(got, again),
                  f"{where}: non-finite, or two calls differ")
            bad, ep, _ = out_errors(got, want)
            check(bad == 0, f"{where}: {bad} values beyond tolerance")
            checked.append(dict(shape=where[len(tag) + 1:], max_abs_err=ep))
            if time_it:
                mask = band_mask(S, q_off, q_off + S, q_off + S + 1)
                kc, vc = k[:, :q_off + S], v[:, :q_off + S]
                flops, bnd = fwd_bound(B, nh, kh, d, S, q_off, q_off + S, 2)
                timed[S] = dict(max_abs_err=ep, shape=where[len(tag) + 1:],
                                **hd_timed(
                    tag, f"flash_prefill {where}",
                    lambda: FP.flash_prefill_qkv(q, k, v, nh, kh, q_off),
                    lambda: FP.flash_prefill_plain(q, k, v, nh, kh, q_off, sm),
                    lambda: sdpa(q, kc, vc, nh, kh, mask=mask), 1, flops,
                    bnd, plain_iters=None if d in HD_NEW else 3))
                del mask, kc, vc
            del q, k, v, got, again, want
        ep = max(c["max_abs_err"] for c in checked[:n_path])
        print(f"[{tag}] K4 on its path: {n_path} chunks of the "
              f"chunked generates within tolerance, each twice, bitwise "
              f"equal (max_abs_err {ep:.3e})")
        r["flash_prefill"] = dict(timed[HD_CHUNK], path_chunks=checked[:n_path],
                                  **({"long_context": timed[512]}
                                     if 512 in timed else {}))

        # the ring's cut hop (queries past the keys' end) and rows that see
        # no key
        if d == 128 or d in HD_ENDS:
            rect = []
            for dtype in (bf16, f32):
                for tq, q_off, keys, W, kh in ((1023, 1023, 1023, 1024, kv),
                                               (1023, 1023, 1023, 1024, nh),
                                               (200, 100, 150, 90, kv)):
                    q, k, v, do = inputs(2, tq, nh, kh, d, dtype, keys, q_off,
                                         W)
                    a = (True, sm, W, False, q_off)
                    got = fwd(q, k, v, nh, kh, *a)
                    g = bwd(q, k, v, *got, do, nh, kh, *a)
                    want = FG.flash_gqa_fwd_plain(q, k, v, nh, kh, *a)
                    gw = FG.flash_gqa_bwd_plain(q, k, v, *got, do, nh, kh, *a)
                    torch.cuda.synchronize()
                    where = (f"{tag} {str(dtype)[6:]} rectangle {tq} rows at "
                             f"q_offset {q_off} against {keys} keys W={W} "
                             f"KH={kh}")
                    ef = hd_check_fwd(where, got, want)
                    dead = torch.isinf(got[1]).sum().item()
                    eb = hd_check_bwd(where, g, gw, terms(
                        q, k, v, *got, do, nh, kh, *a))
                    rect.append(dict(where=where[len(tag) + 1:], out_err=ef,
                                     grad_err=eb, rows_without_keys=dead))
                    print(f"[{tag}] {where[len(tag) + 1:]}: out max_abs_err "
                          f"{ef:.3e}, dq/dk/dv {eb:.3e}, {dead} (head, row)s "
                          f"see no key (as the plain version)")
            r["flash_gqa_fwd"]["rectangles"] = rect

        rsc = hd_resources(d)
        if d in FA.ROPE_HEAD_DIMS:
            rsc.update({f"{k}_rope_band": v for k, v in
                        hd_resources(d, rope=True, band=True).items()})
        print(f"[{tag}] resources: " + "; ".join(
            f"{k} {v['registers']} registers, {v['spill_bytes']} B spilled, "
            f"{v['smem_bytes']} B shared, {v['threads']} threads"
            for k, v in rsc.items()))
        for kname in r:
            r[kname]["resources"] = rsc
        res[d] = r
        torch.cuda.empty_cache()

    # the D = 16 build's other head dims: edge rows and K4's (last, so that
    # the head dims above draw the inputs they drew before these existed)
    for d in HD_EDGE_ONLY:
        nh, kv = HD_HEADS[d], HD_KV[d]
        tag = f"kernels-d{d}"
        res[d] = dict(edges=edges(d, nh, kv, tag), k4=k4_edges(d, nh, kv, tag),
                      resources=hd_resources(d, rope=d % 2 == 0, band=True))

    # the largest admitted head dim and the odd atom count: edge rows, the
    # square path MHA and GQA in bf16 (checked, each backward twice and
    # bitwise equal; not timed: no model path) and K4's edges
    for d in HD_CHECK_ONLY:
        nh, kv, sm = HD_HEADS[d], HD_KV[d], 1.0 / math.sqrt(d)
        tag = f"kernels-d{d}"
        square = {}
        for kh in (nh, kv):
            B, T = 8, 1024
            q, k, v, do = inputs(B, T, nh, kh, d, bf16)
            got = fwd(q, k, v, nh, kh, True, sm)
            want = FG.flash_gqa_fwd_plain(q, k, v, nh, kh, True, sm)
            g = bwd(q, k, v, *got, do, nh, kh, True, sm)
            g2 = bwd(q, k, v, *got, do, nh, kh, True, sm)
            gw = FG.flash_gqa_bwd_plain(q, k, v, *got, do, nh, kh, True, sm)
            torch.cuda.synchronize()
            where = f"{tag} bf16 B={B} T={T} NH={nh} KH={kh} causal"
            check(all(torch.equal(x, y) for x, y in zip(g, g2)),
                  f"{where}: backward differs between two calls")
            ef = hd_check_fwd(where, got, want)
            eb = hd_check_bwd(where, g, gw, terms(q, k, v, *got, do, nh, kh,
                                                  True, sm))
            square[f"KH={kh}"] = dict(out_err=ef, grad_err=eb)
            print(f"[{tag}] {where[len(tag) + 1:]}: out max_abs_err "
                  f"{ef:.3e}, dq/dk/dv {eb:.3e}; backward twice, bitwise "
                  f"equal")
            del q, k, v, do, got, want, g, g2, gw
        res[d] = dict(edges=edges(d, nh, kv, tag), square=square,
                      k4=k4_edges(d, nh, kv, tag), resources=hd_resources(d))
        print(f"[{tag}] resources: " + "; ".join(
            f"{k} {v['registers']} registers, {v['spill_bytes']} B spilled, "
            f"{v['smem_bytes']} B shared, {v['threads']} threads"
            for k, v in res[d]["resources"].items()))
        torch.cuda.empty_cache()
    return res


def phase_bwd_seeds():
    """D = 32's rope + W=1024 B=2 T=8192 backward, MHA (24 heads) and GQA
    (8 kv heads), at seeds 0 .. HD_SEEDS - 1 (on request only).  For each
    seed and each of dq, dk, dv: the kernel's and the plain version's
    errors against the unrounded function (`flash_bwd_plain` on the inputs
    in fp32: no bf16 rounding of the rotated q and k, q^, p or ds), rms and
    largest; of the values where the two differ, how many the kernel holds
    nearer to it and how many farther; the values past `grad_errors` of
    kernel against plain with the rms bound alone and with the one-term
    allowance (`bwd_term_norms`), and of each against the unrounded
    function.  Prints the values past the rms bound, then one JSON line."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    d, B, T, W = 32, 2, 8192, 1024
    nh, kv, sm = HD_HEADS[d], HD_KV[d], 1.0 / math.sqrt(d)
    groups, a = nh // 6, (True, sm, W, True)
    pw = dict(causal=True, sm_scale=sm, window=W, rope=True)
    rows = []
    for seed in range(HD_SEEDS):
        for kh in (nh, kv):
            gen = hd_gen(B, T, nh, kh, d, "bwd-seeds", seed=seed)
            q, do = (torch.randn(B, T, nh * d, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(B, T, kh * d, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2))
            if kh == nh:
                out, lse = FA.flash_fwd_cuda(q, k, v, nh, *a)
                g = FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, *a)
            else:
                out, lse = FG.flash_gqa_fwd_cuda(q, k, v, nh, kh, *a)
                g = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, nh, kh, *a)
            gw = hd_plain(FA.flash_bwd_plain, groups, q, k, v, nh, kh, out,
                          lse, do, **pw)
            ref = hd_plain(FA.flash_bwd_plain, groups, *(t.float() for t in (
                q, k, v)), nh, kh, out.float(), lse, do.float(), **pw)
            norms = hd_plain(bwd_term_norms, groups, q, k, v, nh, kh, out,
                             lse, do, **pw)
            torch.cuda.synchronize()
            for name, x, y, r, t in zip(("dq", "dk", "dv"), g, gw, ref, norms):
                xf, yf = x.float(), y.float()
                ek, ep = (xf - r).abs(), (yf - r).abs()
                apart = xf != yf
                row = dict(
                    seed=seed, kv_heads=kh, grad=name,
                    rms_err_kernel=ek.square().mean().sqrt().item(),
                    rms_err_plain=ep.square().mean().sqrt().item(),
                    max_err_kernel=ek.max().item(),
                    max_err_plain=ep.max().item(),
                    differ=apart.sum().item(),
                    kernel_nearer=(ek < ep)[apart].sum().item(),
                    kernel_farther=(ek > ep)[apart].sum().item(),
                    past_rms_bound=grad_errors(x, y)[0],
                    past_with_allowance=grad_errors(x, y, t)[0],
                    kernel_past_vs_exact=grad_errors(x, r)[0],
                    plain_past_vs_exact=grad_errors(y, r)[0])
                rows.append(row)
                if row["past_rms_bound"]:
                    dd = (xf - yf).abs()
                    rms = yf.square().mean().sqrt()
                    rr = yf.square().mean(-1, keepdim=True).sqrt().clamp(min=rms)
                    lim = 2.0 ** -7 * torch.maximum(xf.abs(), yf.abs()) + 2.0 ** -6 * rr
                    for i in torch.nonzero(dd > lim)[:8].tolist():
                        i = tuple(i)
                        print(f"[bwd-seeds] seed {seed} KH={kh} {name} "
                              f"{i}: kernel {xf[i].item():.6f}, plain "
                              f"{yf[i].item():.6f}, unrounded "
                              f"{r[i].item():.6f}; rms bound "
                              f"{lim[i].item():.3e}, term norm "
                              f"{t[i].item():.3e}, allowance "
                              f"{2.0 ** -7 * t[i].item():.3e}")
                print(f"[bwd-seeds] seed {seed} KH={kh} {name}: rms err "
                      f"kernel {row['rms_err_kernel']:.4e} plain "
                      f"{row['rms_err_plain']:.4e}; max {row['max_err_kernel']:.3e}"
                      f" / {row['max_err_plain']:.3e}; {row['differ']} differ, "
                      f"kernel nearer {row['kernel_nearer']}, farther "
                      f"{row['kernel_farther']}; past the rms bound "
                      f"{row['past_rms_bound']}, with the allowance "
                      f"{row['past_with_allowance']}; against the unrounded "
                      f"function kernel {row['kernel_past_vs_exact']}, plain "
                      f"{row['plain_past_vs_exact']}")
            del q, k, v, do, out, lse, g, gw, ref, norms
            torch.cuda.empty_cache()
    tot = {key: sum(r[key] for r in rows) for key in (
        "differ", "kernel_nearer", "kernel_farther", "past_rms_bound",
        "past_with_allowance", "kernel_past_vs_exact", "plain_past_vs_exact")}
    print("[bwd-seeds] totals over " + f"{HD_SEEDS} seeds x 2 geometries x 3 "
          f"gradients: " + json.dumps(tot))
    print("[bwd-seeds] " + json.dumps(rows))
    return rows


def hd_grads_vs_dense(tag, overrides, B, rows=None, T=None,
                      preset="gpt2-124m"):
    """The first batch's fp32 loss and gradient of GPT-2 124M (or
    `preset`) at a head dim
    (`overrides`, the loop's seeded initial parameters and loader) through
    the flash route (the kernels' fp32 instances) against the dense route
    (use_flash=False): loss rtol 1e-5, every leaf within 1e-4 of its L2
    norm (summation order alone: about 1e-6; a kernel gone wrong at one
    head dim moves its leaves by percents).  rows / T cut the batch (the
    dense route's fp32 (B, heads, T, T) tensors at T=8192 outgrow the
    card).  Returns {leaf: relative L2 error}, the losses and the flash
    route's launches."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.train import loop
    over = dict(overrides)
    kv = over.pop("num_kv_heads", 0)
    cfg = get_config(preset, num_kv_heads=kv, **over)
    tc = loop.TrainConfig(preset=preset, dataset="", batch_size=B,
                          kv_heads=kv, model_overrides=over or None)
    loader, _ = loop._loader(tc, cfg, 0, device_normalize=False,
                             shard=(0, 1))
    x, y = loader.next_batch()
    x, y = x[:rows, :T], y[:rows, :T]
    cfg32 = cfg.replace(dtype="float32")
    host = P.init_params(cfg32, torch.Generator().manual_seed(tc.seed))
    xs, ys = (torch.as_tensor(np.ascontiguousarray(a), device="cuda").long()
              for a in (x, y))

    def run(c):
        p = {k: t.to("cuda").requires_grad_(True) for k, t in host.items()}
        reset_counts()
        loss = M.loss_fn(p, xs, ys, c)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: (t.grad if t.grad is not None
                                 else torch.zeros_like(t))
                             for k, t in p.items()}, read_counts()
    lf, gf, cf = run(cfg32)
    L = cfg.num_layers
    fk, bk = (("flash_gqa_fwd", "flash_gqa_bwd") if kv
              else ("flash_fwd", "flash_bwd"))
    check(cf[fk] == L and cf[bk] == L, f"{tag} fp32 flash route launches {cf}")
    ld, gd, cd = run(cfg32.replace(use_flash=False))
    check(cd[fk] == 0 and cd[bk] == 0, f"{tag} dense route launches {cd}")
    errs = {k: ((gf[k] - gd[k]).norm() / gd[k].norm().clamp_min(1e-30)).item()
            for k in gd}
    worst = max(errs, key=errs.get)
    check(abs(lf - ld) <= 1e-5 * abs(ld), f"{tag} fp32 loss flash {lf} vs "
          f"dense {ld}")
    check(errs[worst] <= 1e-4, f"{tag} fp32 gradient of {worst}: relative "
          f"L2 error {errs[worst]:.3e} against the dense route; {errs}")
    print(f"[{tag}] first batch ({xs.shape[0]} x {xs.shape[1]}) fp32 through "
          f"the kernels vs the dense route: loss {lf:.6f} / {ld:.6f}; worst "
          f"leaf {worst} {errs[worst]:.3e} (L2, relative, bound 1e-4; median "
          f"{float(np.median(list(errs.values()))):.3e}); {L} {fk} + {L} {bk} "
          f"launches, none on the dense route")
    del gf, gd, host
    torch.cuda.empty_cache()
    return dict(loss=[lf, ld], grad_rel_err=errs, worst=worst, launches=cf)


def hd_chunked_generate(tag, cfg, pp, path):
    """A chunked prefill of seeded HD_PROMPT-token prompts in HD_CHUNK
    chunks through the kernels (the first chunk K1-fwd or K3-fwd, the rest
    K4), greedy, with prepared params pp, at `path`, an entry of
    HD_K4_PATHS (the geometry kernels-head-dims holds K4 at):
    (launches, tokens, ms of the generate call)."""
    from vitrs_tpu_torch.models import generate as G
    dname, B, kh, max_new = path
    T0, chunk = HD_PROMPT, HD_CHUNK
    check(cfg.dtype == dname and cfg.kv_heads == kh, f"{tag} chunked "
          f"generate: {cfg.dtype}, {cfg.kv_heads} kv heads off its path "
          f"{path}")
    prompt = torch.as_tensor(np.random.default_rng(T0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.generate(pp, prompt, cfg, max_new, temperature=0.0,
                     prefill_chunk=chunk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    L = cfg.num_layers
    first = "flash_gqa_fwd" if cfg.is_gqa else "flash_fwd"
    want = designed(**{first: L, "flash_prefill": L * (T0 // chunk - 1)},
                    gelu_fwd=L * (T0 // chunk + max_new - 1))
    check(counts == want, f"{tag} chunked generate launches {counts} != "
          f"{want}")
    check(out.shape == (B, T0 + max_new), f"{tag} generate shape")
    return counts, out, ms


def phase_train_head_dim(smi, d):
    """GPT-2 124M at full width and depth with heads of d (C = 768; D = 512
    at gpt2-350m's C = 1024 and 24 layers), B=8 T=1024: 12 steps at D =
    128, 4 at the others, through train/loop.train (L K1-fwd, L K2 a step,
    as designed) and the first batch's fp32 gradient against the dense
    route; then with HD_KV[d] kv heads: at D = 128 and 16 the train-window
    model (rope, W=1024, T=8192, B=2, 12 steps; K3 with the rotation
    and the band; its gradient check on the first row's 2048 tokens), at
    the others four steps at T=1024 (L K3-fwd, L K3-bwd a step), at 8, 384
    and 512 also the first batch's fp32 gradient against the dense route;
    and, but at D = 128 and 8 (served by serve-d128 / serve-d8), a chunked
    generate of the GQA model (K3-fwd, then K4).  No flash plain version
    runs on the card (`_watch_plain`)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    _watch_plain()
    PLAIN_ON_CARD.update(fwd=0, bwd=0)
    nh, kv = HD_HEADS[d], HD_KV[d]
    preset = HD_PRESET.get(d, "gpt2-124m")
    steps = 12 if d == 128 else 4
    tag = f"train-d{d}"
    counts, res = phase_train(smi, steps=steps, overrides={"num_heads": nh},
                              tag=f"[{tag}]", n_params=HD_PARAMS[d],
                              preset=preset)
    res["grads"] = hd_grads_vs_dense(tag, {"num_heads": nh}, 8, preset=preset)
    if d in (128, 16):
        # 12 steps: at lr 6e-4 after a 2-step warm-up the window model's
        # loss rises above step 1's at step 4 before it falls
        gcounts, gres = phase_train(
            smi, steps=12, kv_heads=kv,
            overrides=dict(WINDOW, num_heads=nh), B=2, tag=f"[{tag}-gqa]",
            n_params=HD_GQA_WINDOW_PARAMS if d == 128 else HD_GQA_PARAMS[d])
        gres["grads"] = hd_grads_vs_dense(
            f"{tag}-gqa", dict(WINDOW, num_heads=nh, num_kv_heads=kv), 2,
            rows=1, T=2048)
    else:
        gcounts, gres = phase_train(smi, steps=4, kv_heads=kv,
                                    overrides={"num_heads": nh}, B=8,
                                    tag=f"[{tag}-gqa]",
                                    n_params=HD_GQA_PARAMS[d], preset=preset)
        if d not in (32, 256):
            gres["grads"] = hd_grads_vs_dense(
                f"{tag}-gqa", {"num_heads": nh, "num_kv_heads": kv}, 8,
                preset=preset)
    if d not in (128, 8):
        cfg = get_config(preset, num_heads=nh, num_kv_heads=kv,
                         dtype="bfloat16")
        pp = M.prepare_params({k: t.to("cuda") for k, t in P.init_params(
            cfg, torch.Generator().manual_seed(5)).items()}, cfg)
        pcounts, _, _ = hd_chunked_generate(tag, cfg, pp, HD_K4_PATHS[d][0])
        del pp
        gres["generate_launches"] = pcounts
        print(f"[{tag}-gqa] chunked generate (B=2, 768-token prompt in "
              f"256-token chunks): flash_gqa_fwd "
              f"{pcounts['flash_gqa_fwd']}, flash_prefill "
              f"{pcounts['flash_prefill']} launches")
    check(PLAIN_ON_CARD == {"fwd": 0, "bwd": 0}, f"[{tag}] a flash plain "
          f"version ran on the card {PLAIN_ON_CARD}")
    print(f"[{tag}] flash plain versions called on the card: 0")
    return counts, res, gcounts, gres


def phase_serve_head_dim(smi, d):
    """GPT-2 124M's width at HD_HEADS[d] heads of d (6 x 128, 96 x 8;
    seeded random weights) served: bf16 through GenerationEngine (8
    requests, whole-prompt prefill through K1-fwd, launches == 12 x
    prefill dispatches), prefill ms and decode ms a token; a chunked
    generate (768-token prompts in 256-token chunks: K1-fwd, then K4; a
    512-token chunk leaves no second chunk within GPT-2's 1024 positions);
    then fp32 greedy tokens, whole and chunked, equal to the dense route's
    (use_flash=False)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    _watch_plain()
    PLAIN_ON_CARD.update(fwd=0, bwd=0)
    nh, tag = HD_HEADS[d], f"[serve-d{d}]"
    cfg = get_config("gpt2-124m", num_heads=nh, dtype="bfloat16")
    L = cfg.num_layers
    check(P.num_parameters(cfg) == 124_439_808, f"gpt2-124m {nh} x {d} params")
    host = P.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v.to("cuda") for k, v in host.items()}
    rng = np.random.default_rng(0)
    lengths = (5, 37, 128, 300, 511, 700, 900, 960)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    res = {}
    for rnd in range(2):                      # warm-up, then timed
        eng = GenerationEngine(params, cfg, max_slots=8, max_len=1024,
                               prompt_buckets=(128, 512, 1024),
                               decode_chunk=16)
        for p in prompts:
            eng.submit(p, max_new=32)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = dict(eng.run())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    check(counts == designed(flash_fwd=L * eng.prefill_dispatches,
                             gelu_fwd=L * (eng.prefill_dispatches
                                           + eng.decode_ticks)),
          f"{tag} engine launches {counts}")
    for i, n in enumerate(lengths):
        check(len(outs[i]) == n + 32, f"{tag} request {i} length")
    res.update(prefill_ms=(t1 - t0) * 1e3, decode_ms_per_token=(t2 - t1)
               * 1e3 / 32, engine_launches=counts["flash_fwd"],
               prefill_dispatches=eng.prefill_dispatches)
    print(f"{tag} {nh} x {d} gpt2-124m bf16 engine, 8 requests x 32 new: "
          f"{eng.prefill_dispatches} prefill dispatches, {counts['flash_fwd']}"
          f" K1-fwd launches; prefill {res['prefill_ms']:.2f} ms, decode "
          f"{res['decode_ms_per_token']:.3f} ms a step of 8 tokens  ({smi})")
    pp = M.prepare_params(params, cfg)
    for _ in range(2):                        # warm-up, then timed
        pcounts, _, ms = hd_chunked_generate(tag, cfg, pp, HD_K4_PATHS[d][0])
    res.update(chunked_prefill_ms=ms, chunked_launches=pcounts)
    print(f"{tag} chunked prefill B=8, 768 tokens in 256-token "
          f"chunks, 1 new token: flash_fwd {pcounts['flash_fwd']}, "
          f"flash_prefill {pcounts['flash_prefill']} launches; {ms:.2f} ms")
    del params, eng, pp
    res["fp32_greedy_equal"] = hd_greedy_vs_dense(
        tag, cfg.replace(dtype="float32"), host, HD_K4_PATHS[d][1])
    check(PLAIN_ON_CARD == {"fwd": 0, "bwd": 0}, f"{tag} a flash "
          f"plain version ran on the card {PLAIN_ON_CARD}")
    print(f"{tag} fp32 greedy, B=2, 768-token prompt + 32 new: whole "
          f"(K1-fwd) and chunked (K1-fwd + K4) tokens equal to the dense "
          f"route's; flash plain versions on the card: 0")
    return res


def hd_greedy_vs_dense(tag, cfg32, host, path):
    """fp32 greedy tokens of a seeded prompt of HD_PROMPT tokens, whole and
    in HD_CHUNK chunks, through the kernels (fp32 instances) against the
    dense route (use_flash=False), at `path` of HD_K4_PATHS (float32, MHA):
    equal, with K1-fwd L times and K4 L a chunk past the first."""
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    L = cfg32.num_layers
    pp = M.prepare_params({k: v.to("cuda") for k, v in host.items()}, cfg32)
    dname, B, _, new = path
    check(dname == "float32", f"{tag} greedy path {path}")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B, HD_PROMPT)), device="cuda")
    toks = {}
    for route, c in (("flash", cfg32), ("dense", cfg32.replace(use_flash=False))):
        for chunk in (0, HD_CHUNK):
            reset_counts()
            toks[route, chunk] = G.generate(pp, prompt, c, new, temperature=0.0,
                                            prefill_chunk=chunk).cpu()
            n = read_counts()
            passes = (HD_PROMPT // HD_CHUNK if chunk else 1) + new - 1
            want = (designed(flash_fwd=L, flash_prefill=(
                HD_PROMPT // HD_CHUNK - 1) * L if chunk else 0,
                gelu_fwd=L * passes)
                    if route == "flash" else designed(gelu_fwd=L * passes))
            check(n == want, f"{tag} fp32 {route} chunk {chunk} "
                  f"launches {n} != {want}")
    for chunk in (0, HD_CHUNK):
        a, b = toks["flash", chunk], toks["dense", chunk]
        diff = (a != b).nonzero()
        check(diff.numel() == 0, f"{tag} fp32 greedy chunk {chunk}: "
              f"first token that differs from the dense route at (row, "
              f"position) {diff[0].tolist() if diff.numel() else None}")
    return True


def phase_nano(smi):
    """gpt-nano itself (2 heads of 8, T=16, vocab 97), the repo's own
    preset whose attention the JAX package runs on its Pallas kernels with
    16 phantom heads: `python -m vitrs_tpu_torch.cli.train --preset
    gpt-nano` on the card (its main, in this process), 6 steps at B=32 (2
    K1-fwd + 2 K2 + 1 K7 a step, no plain flash version on the card); then fp32
    greedy generation of 8 prompts through GenerationEngine (bucket 16)
    against the dense route's tokens (use_flash=False), equal."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.cli import train as CT
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    _watch_plain()
    PLAIN_ON_CARD.update(fwd=0, bwd=0)
    cfg = get_config("gpt-nano")
    L, steps = cfg.num_layers, 6
    check(cfg.head_size == 8 and cfg.num_heads == 2, "gpt-nano geometry")
    with tempfile.TemporaryDirectory() as work:
        reset_counts()
        t0 = time.perf_counter()
        CT.main(["--preset", "gpt-nano", "--dataset", "", "--steps",
                 str(steps), "--batch-size", "32", "--log-every", "1",
                 "--warmup", "1", "--ckpt-every", "0", "--workdir", work])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
    # a vocab of 97 takes the plain cross-entropy (fused_ce.supports: the
    # JAX rule wants V >= 16384), as in the JAX package
    want = designed(flash_fwd=L * steps, flash_bwd=L * steps, adamw=steps,
                    gelu_fwd=L * steps, gelu_bwd=L * steps)
    check(counts == want, f"[nano] cli.train launches {counts} != {want}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"[nano] losses {losses}")
    print(f"[nano] cli.train --preset gpt-nano, {steps} steps B=32 T=16 on "
          f"the card: losses {[round(x, 4) for x in losses]}; launches "
          f"flash_fwd {counts['flash_fwd']}, flash_bwd {counts['flash_bwd']}"
          f"; wall {wall:.1f} s incl. init  ({smi})")
    cfg32 = cfg.replace(dtype="float32")
    host = P.init_params(cfg32, torch.Generator().manual_seed(3))
    params = {k: v.to("cuda") for k, v in host.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1, 3, 5, 7, 8,
                                                            9, 10, 12)]
    toks, gen_counts = {}, {}
    for route, c in (("flash", cfg32), ("dense", cfg32.replace(use_flash=False))):
        eng = GenerationEngine(params, c, max_slots=8, max_len=16,
                               prompt_buckets=(16,))
        for p in prompts:
            eng.submit(p, max_new=16 - len(p))
        reset_counts()
        toks[route] = dict(eng.run())
        gen_counts[route] = read_counts()
        passes = eng.prefill_dispatches + eng.decode_ticks
        check(gen_counts[route] == designed(**(
            {"flash_fwd": L * eng.prefill_dispatches} if route == "flash"
            else {}), gelu_fwd=L * passes),
              f"[nano] {route} engine launches {gen_counts[route]}")
    check(toks["flash"].keys() == toks["dense"].keys() and all(
        np.array_equal(toks["flash"][i], toks["dense"][i])
        for i in toks["flash"]), f"[nano] fp32 greedy tokens differ from "
        f"the dense route's: {toks}")
    check(PLAIN_ON_CARD == {"fwd": 0, "bwd": 0}, f"[nano] a flash plain "
          f"version ran on the card {PLAIN_ON_CARD}")
    print(f"[nano] fp32 greedy through GenerationEngine, 8 prompts of 1-12 "
          f"tokens to 16: tokens equal to the dense route's; "
          f"{gen_counts['flash']['flash_fwd']} K1-fwd launches; flash plain "
          f"versions on the card: 0")
    return counts, dict(losses=losses, wall_s=wall,
                        engine_launches=gen_counts["flash"]["flash_fwd"])


# the benchmark cells' MLP activations (rows, 4C): GPT-2 124M training
# (B=64, T=1024), ViT-B/16 training (B=128, T=197) and inference (B=256)
GELU_SHAPES = (("gpt2-124m.train", (64 * 1024, 3072)),
               ("vit-b-16.train", (128 * 197, 3072)),
               ("vit-b-16.infer", (256 * 197, 3072)))


def bf16_ulps(a, b):
    """Per-element distance of two bf16 tensors in units in the last place
    (their bit patterns as ordered integers)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def gelu_resources():
    """{kernel: (registers, spill store bytes, spill load bytes)} of every
    instance in csrc/gelu.cu, from ptxas's log; fails on a spill."""
    import re
    from vitrs_tpu_torch.ops import _build
    res, name = {}, None
    for line in _build.load("gelu").log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            res[name] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            res[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name][0] = int(m.group(1))
    check(len(res) == 8, f"gelu: {len(res)} kernels in ptxas's log, not 8")
    for name, (regs, st, ld) in res.items():
        check(st == 0 and ld == 0, f"gelu kernel {name} spills {st} / {ld} "
              f"bytes")
    return res


def phase_kernels_gelu():
    """The GELU kernels against the eager chain at the cells' shapes, then
    their times, both forms, forward and backward, bf16."""
    import torch.nn.functional as F
    from vitrs_tpu_torch.ops import basic
    from vitrs_tpu_torch.ops import fused_gelu as FG
    rsc = gelu_resources()
    for name, (regs, st, ld) in sorted(rsc.items()):
        print(f"[kernels-gelu] {name}: {regs} registers, {st} / {ld} B "
              f"spilled")
    gen = torch.Generator(device="cuda").manual_seed(22)
    bf16 = torch.bfloat16
    res = {}
    for cell, shape in GELU_SHAPES:
        x = (3.0 * torch.randn(shape, generator=gen, device="cuda")).to(bf16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        n = x.numel()
        for erf in (False, True):
            form = "erf" if erf else "tanh"
            got = FG.gelu_fwd_cuda(x, erf)
            want = basic.gelu_fwd_plain(x, erf)
            diff = (got.view(torch.int16) != want.view(torch.int16)).sum()
            check(diff.item() == 0, f"gelu {form} forward at {shape}: "
                  f"{diff.item()} values differ from the eager chain")
            del got, want
            got = FG.gelu_bwd_cuda(x, dy, erf)
            want = basic.gelu_bwd_plain(x, dy, erf)
            ulp = bf16_ulps(got, want).max().item()
            check(ulp <= 1.0, f"gelu {form} backward at {shape}: "
                  f"{ulp} bf16 ulps from the eager chain")
            del got, want
            approx = "none" if erf else "tanh"
            rows = {}
            for way, nbytes, kern, plain, lib in (
                    ("fwd", 4 * n, lambda: FG.gelu_fwd_cuda(x, erf),
                     lambda: basic.gelu_fwd_plain(x, erf),
                     lambda: F.gelu(x, approximate=approx)),
                    ("bwd", 6 * n, lambda: FG.gelu_bwd_cuda(x, dy, erf),
                     lambda: basic.gelu_bwd_plain(x, dy, erf),
                     lambda: torch.ops.aten.gelu_backward(
                         dy, x, approximate=approx))):
                km, pm, raw = timed_pair(kern, plain, iters=20,
                                         plain_iters=5)
                lib_ms = cuda_ms(lib)
                bms = nbytes / HBM_BYTES_S * 1e3
                rows[way] = dict(ms=km, plain_ms=pm, library_ms=lib_ms,
                                 bound_ms=bms, bound_by="bytes",
                                 share=bms / km, raw=raw)
                print(f"[kernels-gelu] {cell} {shape} {form} {way}: kernel "
                      f"{raw[0]:.4f}/{raw[1]:.4f} ms ({100 * bms / km:.1f}% "
                      f"of the {bms:.4f} ms byte bound), eager chain "
                      f"{raw[2]:.4f}/{raw[3]:.4f} ms, F.gelu "
                      f"{lib_ms:.4f} ms")
            rows["bwd_max_ulp"] = ulp
            res[f"{cell}.{form}"] = rows
        del x, dy
    res["resources"] = rsc
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import vitrs_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --phases a,b,...: run only those (no result lines); for iterating
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        only = set(sys.argv[2].split(","))
    smi = phase_device()
    R = {}
    phases = (
        ("kernels", phase_kernels),
        ("serve", lambda: phase_serve(smi)),
        ("xdevice", phase_xdevice),
        ("kernels-train", phase_kernels_train),
        ("train", lambda: phase_train(smi)),
        ("xdevice-train", phase_xdevice_train),
        ("kernels-gqa", phase_kernels_gqa),
        ("kernels-prefill", phase_kernels_prefill),
        ("train-gqa", lambda: phase_train(smi, kv_heads=4)),
        ("serve-gqa", lambda: phase_serve_gqa(smi)),
        ("xdevice-gqa", phase_xdevice_gqa),
        ("kernels-rope-window", phase_kernels_rope_window),
        ("kernels-headce", phase_kernels_headce),
        ("train-window", lambda: phase_train_window(smi)),
        ("train-headce", lambda: phase_train_headce(smi, R["train"][1])),
        ("serve-window", lambda: phase_serve_window(smi)),
        ("xdevice-window", phase_xdevice_window),
        ("kernels-vit", phase_kernels_vit),
        ("kernels-families", phase_kernels_families),
        ("infer-vit", lambda: phase_infer_vit(smi)),
        ("train-vit", lambda: phase_train_vit(smi)),
        ("xdevice-vit", phase_xdevice_vit),
        ("kernels-moe", phase_kernels_moe),
        ("train-moe", lambda: phase_train_moe(smi)),
        ("train-muon", lambda: phase_train(smi, tag="[train-muon]",
                                           optimizer="muon", lr=0.02)),
        ("serve-moe", lambda: phase_serve_moe(smi)),
        ("xdevice-moe", phase_xdevice_moe),
        ("kernels-remat", phase_kernels_remat),
        ("train-remat", lambda: phase_train_remat(smi)),
        ("train-vit-stream", lambda: phase_train_vit_stream(smi, decoder)),
        ("resume", lambda: phase_resume(smi)),
        ("serve-paged", lambda: phase_serve_paged(smi)),
        ("serve-int8", lambda: phase_serve_int8(smi)),
        ("serve-beam", lambda: phase_serve_beam(smi)),
        ("serve-spec", lambda: phase_serve_spec(smi)),
        ("infer-vit-quant", lambda: phase_infer_vit_quant(smi)),
        ("pretrain-mae", lambda: phase_pretrain_mae(smi)),
        ("finetune-lora", lambda: phase_finetune_lora(smi, R["train"][1])),
        ("train-clip", lambda: phase_train_clip(smi)),
        ("quirks", lambda: phase_quirks(smi)),
        ("bitexact", phase_bitexact),
        ("import-hf", phase_import_hf),
        ("ops", phase_ops),
        ("serve-export", lambda: phase_serve_export(smi, export_dir)),
        ("serve-batching", lambda: phase_serve_batching(
            smi, R["serve-export"]["vit_path"])),
        ("debug", phase_debug),
        ("meshes", lambda: phase_meshes(smi)),
        ("comm-nccl", phase_comm_nccl),
        ("kernels-tp-pp", phase_kernels_tp_pp),
        ("meshes-tp-pp", lambda: phase_meshes_tp_pp(smi)),
        ("kernels-cp", phase_kernels_cp),
        ("meshes-cp-ep", lambda: phase_meshes_cp_ep(smi)),
        ("kernels-head-dims", phase_kernels_head_dims),
        ("train-d128", lambda: phase_train_head_dim(smi, 128)),
        ("serve-d128", lambda: phase_serve_head_dim(smi, 128)),
        ("train-d32", lambda: phase_train_head_dim(smi, 32)),
        ("train-d256", lambda: phase_train_head_dim(smi, 256)),
        ("nano", lambda: phase_nano(smi)),
        ("train-d8", lambda: phase_train_head_dim(smi, 8)),
        ("serve-d8", lambda: phase_serve_head_dim(smi, 8)),
        ("train-d16", lambda: phase_train_head_dim(smi, 16)),
        ("train-d384", lambda: phase_train_head_dim(smi, 384)),
        ("train-d512", lambda: phase_train_head_dim(smi, 512)),
        ("kernels-gelu", phase_kernels_gelu),
    )
    # the phases that run only when --phases names them
    on_request = (("bwd-seeds", phase_bwd_seeds),)
    # the serving artifacts of serve-export, read again by serve-batching
    export_dir = tempfile.mkdtemp(prefix="vitrs_smoke_export_")
    # the streaming phase decodes with the native libjpeg pipeline, else
    # with the loader's PIL fallback; where neither is there it is left out
    decoder, why = stream_decoder()
    print("[device] train-vit-stream decoder: " + {
        "native": "native jpegpipe (built)",
        "pil": f"PIL, the loader's fallback ({why})",
        None: f"none, so the phase is left out ({why})"}[decoder])
    try:
        for name, fn in phases + on_request:
            if name == "train-vit-stream" and decoder is None:
                continue
            if name in dict(on_request) and (only is None or name not in only):
                continue
            if only is None or name in only:
                t0 = time.perf_counter()
                R[name] = fn()
                print(f"[smoke] phase {name} done in "
                      f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    if only is not None:
        print(f"[smoke] ran {sorted(R)}")
        return
    k1 = R["kernels"]
    serve_launches, prefill_ms, tok_s, serve_counts = R["serve"]
    ktrain = R["kernels-train"]
    counts, train = R["train"]
    kgqa, kprefill = R["kernels-gqa"], R["kernels-prefill"]
    gqa_counts, gqa_train = R["train-gqa"]
    serve_gqa = R["serve-gqa"]
    krw, k8 = R["kernels-rope-window"], R["kernels-headce"]
    win_counts, win_train = R["train-window"]
    h8_counts, h8_train = R["train-headce"]
    serve_win, xwin = R["serve-window"], R["xdevice-window"]
    kvit = R["kernels-vit"]
    infer_counts, infer_vit = R["infer-vit"]
    vit_counts, train_vit = R["train-vit"]
    kmoe, serve_moe = R["kernels-moe"], R["serve-moe"]
    moe_counts, train_moe = R["train-moe"]
    muon_counts, train_muon = R["train-muon"]
    kremat, remat = R["kernels-remat"], R["train-remat"]
    sel, full = remat["True"]["counts"], remat["full"]["counts"]
    stream = R.get("train-vit-stream")
    paged, int8, beam = R["serve-paged"], R["serve-int8"], R["serve-beam"]
    spec, vq = R["serve-spec"], R["infer-vit-quant"]
    kfam = R["kernels-families"]
    mae_counts, mae = R["pretrain-mae"]
    lora_counts, lora = R["finetune-lora"]
    clip_counts, clip = R["train-clip"]
    fa = "vitrs_tpu/ops/flash_attention.py:"
    fg = "vitrs_tpu/ops/flash_attention_gqa.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fa + "567", also_replaces=[fa + "374"],
             launches=counts["flash_fwd"], serve_launches=serve_launches,
             **k1, prefill_ms=prefill_ms, decode_tok_s=tok_s),
        dict(name="flash_bwd", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fa + "844", also_replaces=[fa + "986", fa + "901",
                                                 fa + "418"],
             launches=counts["flash_bwd"], kernels_per_launch=3,
             **ktrain["flash_bwd"]),
        dict(name="ce_fwd", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:69",
             launches=counts["ce_fwd"], **ktrain["ce_fwd"]),
        dict(name="ce_bwd", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:109",
             launches=counts["ce_bwd"], **ktrain["ce_bwd"]),
        dict(name="adamw", route="cuda", source=CSRC + "fused_adamw.cu",
             replaces="vitrs_tpu/ops/fused_adamw.py:28",
             launches=counts["adamw"], vit_launches=vit_counts["adamw"],
             vit=kvit["adamw"], **ktrain["adamw"]),
        dict(name="flash_gqa_fwd", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fg + "358", also_replaces=[fg + "262"],
             launches=gqa_counts["flash_gqa_fwd"],
             serve_launches=serve_gqa[512]["launches"]["flash_gqa_fwd"],
             **kgqa["flash_gqa_fwd"]),
        dict(name="flash_gqa_bwd", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fg + "499", also_replaces=[fg + "538", fg + "470",
                                                 fg + "309"],
             launches=gqa_counts["flash_gqa_bwd"], kernels_per_launch=3,
             **kgqa["flash_gqa_bwd"]),
        dict(name="flash_prefill", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces="vitrs_tpu/ops/flash_prefill.py:123",
             launches=serve_gqa[512]["launches"]["flash_prefill"],
             **kprefill, serve_gqa=serve_gqa),
        # the rope and band variants of the same kernels: launches on the
        # long-context training run, the windowed serving run, and (K3) the
        # rope + window GQA training step of xdevice-window
        dict(name="flash_fwd_rope_window", route="cuda",
             source=CSRC + "flash_fwd.cu", replaces=fa + "567",
             launches=win_counts["flash_fwd"],
             serve_launches=serve_win[512]["launches"]["flash_fwd"],
             **krw["mha_fwd"]),
        dict(name="flash_bwd_rope_window", route="cuda",
             source=CSRC + "flash_bwd.cu", replaces=fa + "844",
             also_replaces=[fa + "986", fa + "901"],
             launches=win_counts["flash_bwd"], kernels_per_launch=3,
             **krw["mha_bwd"]),
        dict(name="flash_gqa_fwd_rope_window", route="cuda",
             source=CSRC + "flash_fwd.cu", replaces=fg + "358",
             launches=xwin[1]["flash_gqa_fwd"], **krw["gqa_fwd"]),
        dict(name="flash_gqa_bwd_rope_window", route="cuda",
             source=CSRC + "flash_bwd.cu", replaces=fg + "499",
             launches=xwin[1]["flash_gqa_bwd"], kernels_per_launch=3,
             **krw["gqa_bwd"]),
        dict(name="flash_prefill_window", route="cuda",
             source=CSRC + "flash_fwd.cu",
             replaces="vitrs_tpu/ops/flash_prefill.py:123",
             launches=serve_win[512]["launches"]["flash_prefill"],
             **krw["prefill"], serve_window=serve_win),
        dict(name="head_ce_fwd", route="cuda",
             source=CSRC + "fused_head_ce.cu",
             replaces="vitrs_tpu/ops/fused_head_ce.py:68",
             launches=h8_counts["head_ce_fwd"], kernels_per_launch=2,
             **k8[8192], r16384=k8[16384], train=h8_train),
        # vit mode: the same kernels at causal=False, T=197 (the Pallas
        # single-tile kernels' path); launches on train-vit (its end-of-run
        # evaluation included) and infer-vit
        dict(name="flash_fwd_vit", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fa + "374", launches=vit_counts["flash_fwd"],
             infer_launches=infer_counts["flash_fwd"], **kvit["fwd"],
             train=train_vit, infer=infer_vit),
        dict(name="flash_bwd_vit", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fa + "418", launches=vit_counts["flash_bwd"],
             kernels_per_launch=3, **kvit["bwd"]),
        # the MoE model (gpt2-moe-8e, B=24, Adafactor): the same kernels at
        # its training shapes; launches on train-moe, serve-moe's engine
        # and chunked generate (K4), and the Muon run of GPT-2 124M
        dict(name="flash_fwd_moe", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fa + "567", launches=moe_counts["flash_fwd"],
             serve_launches=serve_moe["launches"]["flash_fwd"],
             muon_launches=muon_counts["flash_fwd"], **kmoe["flash_fwd"],
             train=train_moe, serve=serve_moe, train_muon=train_muon),
        dict(name="flash_bwd_moe", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fa + "844", also_replaces=[fa + "986", fa + "901"],
             launches=moe_counts["flash_bwd"], kernels_per_launch=3,
             muon_launches=muon_counts["flash_bwd"], **kmoe["flash_bwd"]),
        dict(name="ce_fwd_moe", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:69",
             launches=moe_counts["ce_fwd"],
             muon_launches=muon_counts["ce_fwd"], **kmoe["ce_fwd"]),
        dict(name="ce_bwd_moe", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:109",
             launches=moe_counts["ce_bwd"],
             muon_launches=muon_counts["ce_bwd"], **kmoe["ce_bwd"]),
        dict(name="flash_prefill_moe", route="cuda",
             source=CSRC + "flash_fwd.cu",
             replaces="vitrs_tpu/ops/flash_prefill.py:123",
             launches=serve_moe["generate"][256]["launches"]["flash_prefill"],
             **kmoe["flash_prefill"]),
        # gpt2-124m-4k (B=4, T=4096) under selective remat: K1-fwd in the
        # selective forward only, K2 from the saved out and lse; launches
        # on train-remat's selective run, with the plain and full runs'
        dict(name="flash_fwd_remat", route="cuda",
             source=CSRC + "flash_fwd.cu", replaces=fa + "567",
             launches=sel["flash_fwd"],
             plain_launches=remat["False"]["counts"]["flash_fwd"],
             full_launches=full["flash_fwd"], **kremat["flash_fwd"],
             train=remat, resume=R["resume"]),
        dict(name="flash_bwd_remat", route="cuda",
             source=CSRC + "flash_bwd.cu", replaces=fa + "844",
             also_replaces=[fa + "986", fa + "901"],
             launches=sel["flash_bwd"], kernels_per_launch=3,
             full_launches=full["flash_bwd"], **kremat["flash_bwd"]),
        dict(name="ce_fwd_remat", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:69",
             launches=sel["ce_fwd"], **kremat["ce_fwd"]),
        dict(name="ce_bwd_remat", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:109",
             launches=sel["ce_bwd"], **kremat["ce_bwd"]),
    ]
    # the model families: K1-fwd and K2 at the MAE encoder's shape (its
    # decoder's beside it) with pretrain-mae's launches, at CLIP-L/14's
    # with train-clip's; LoRA runs the MHA training shapes (rows 0-3)
    for part, kname in (("fwd", "flash_fwd"), ("bwd", "flash_bwd")):
        bwd = {} if part == "fwd" else {"kernels_per_launch": 3}
        kernels.append(dict(
            name=f"{kname}_mae", route="cuda", source=CSRC + f"{kname}.cu",
            replaces=fa + ("374" if part == "fwd" else "418"),
            launches=mae_counts[kname], **bwd, **kfam[part]["mae_enc"],
            decoder_shape=kfam[part]["mae_dec"],
            **({"pretrain": mae} if part == "fwd" else {})))
        kernels.append(dict(
            name=f"{kname}_clip", route="cuda", source=CSRC + f"{kname}.cu",
            replaces=fa + ("374" if part == "fwd" else "418"),
            launches=clip_counts[kname], **bwd, **kfam[part]["clip"],
            **({"train": clip} if part == "fwd" else {})))
    for i, kname in enumerate(("flash_fwd", "flash_bwd", "ce_fwd", "ce_bwd")):
        kernels[i]["lora_launches"] = lora_counts[kname]
    kernels[0]["lora"] = lora
    if stream is not None:
        kernels[14]["stream_launches"] = stream[0]["flash_fwd"]
        kernels[14]["stream"] = stream[1]
    kernels[0]["train"] = train
    kernels[5]["train"] = gqa_train
    kernels[8]["train"] = win_train
    # the rest of serving: K1-fwd in the paged engine's page-group
    # prefills, the w8 engine, beam search, the speculative prefills and
    # the int8 ViT forwards; K3-fwd and K4 in the int8-cache 8K prefill
    kernels[0].update(
        serve_paged_launches=paged[16]["launches"]["flash_fwd"],
        serve_paged_chunk1_launches=paged[1]["launches"]["flash_fwd"],
        serve_w8_launches=int8["w8_engine"]["launches"]["flash_fwd"],
        serve_beam_launches=beam["launches"]["flash_fwd"],
        serve_spec_launches=spec["draft"]["launches"]["flash_fwd"],
        infer_quant_launches={k: v["launches"]["flash_fwd"]
                              for k, v in vq.items()},
        serve_paged=paged, serve_beam=beam, serve_spec=spec,
        infer_quant=vq)
    kernels[5].update(
        serve_int8_launches=int8["int8_512"]["launches"]["flash_gqa_fwd"],
        serve_int8=int8)
    kernels[7]["serve_int8_launches"] = (
        int8["int8_512"]["launches"]["flash_prefill"])
    # this slice: every kernel a torch.library op; K1-fwd's launches a call
    # of the exported GPT-2 124M and ViT-B/16; each rank's launches on the
    # dp=2 / fsdp=2 / dp=2,fsdp=2 runs (K7: the ZeRO-1 slice's values)
    exp, meshes, ops = R["serve-export"], R["meshes"], R["ops"]
    by_kernel = {"flash_fwd": 0, "flash_bwd": 1, "ce_fwd": 2, "ce_bwd": 3,
                 "adamw": 4}
    for kname, i in by_kernel.items():
        kernels[i]["mesh_launches"] = {
            spec: meshes[spec]["launches_per_step"].get(kname, 0)
            * TRAIN_STEPS for spec in meshes}
    kernels[4]["dp_values_a_rank"] = meshes["dp=2"]["adamw_values"]
    kernels[0].update(
        export_launches={k: exp[k]["launches"]
                         for k in ("gpt2-124m", "vit-b-16")},
        serve_export=exp, serve_batching=R["serve-batching"],
        dispatch=ops["dispatch"])
    # this slice: K1-fwd and K2 at the tensor-parallel, pipeline and ViT
    # tp=2 shapes; each rank's launches over the meshes-tp-pp runs
    ktp, tppp = R["kernels-tp-pp"], R["meshes-tp-pp"]
    for kname, i in by_kernel.items():
        kernels[i]["tp_pp_launches"] = {
            run: [per.get(kname, 0) * TRAIN_STEPS
                  for per in row["launches_per_step"]]
            for run, row in tppp.items() if "launches_per_step" in row}
        if kname in ktp:
            kernels[i]["tp_pp_shapes"] = ktp[kname]
    # the ring's per-hop routes at the cp shapes (K1-fwd / K2, K3 at 4 kv
    # heads, the banded diagonal, the cut hop's rectangle at 4 and 12 kv
    # heads) and each rank's launches over the meshes-cp-ep runs; the cut
    # hops each rank counted, the plain versions it ran on the card (none)
    kcp, cpep = R["kernels-cp"], R["meshes-cp-ep"]
    by_kernel.update(flash_gqa_fwd=5, flash_gqa_bwd=6)
    for kname, i in by_kernel.items():
        kernels[i]["cp_ep_launches"] = {
            run: [per.get(kname, 0) * TRAIN_STEPS
                  for per in row["launches_per_step"]]
            for run, row in cpep.items() if "launches_per_step" in row}
        if kname in kcp:
            kernels[i]["cp_ep_shapes"] = kcp[kname]
    for i in (5, 6):
        for key in ("cut_hops", "plain_on_card"):
            kernels[i][f"cp_{key}"] = {run: row[key] for run, row in
                                       cpep.items() if key in row}
    kernels[0]["cp_rectangles"] = kcp["rect"]
    kernels[0]["cp_merge"] = kcp["merge"]
    # this slice: the flash kernels at head dims 32, 128 and 256, each row's
    # launches from its head dim's training run (K1-fwd / K2 MHA, K3 with
    # kv heads) or chunked prefill (K4: serve-d128's bf16 one, else the GQA
    # model's of phase train-d32 / train-d256), and its time and error at
    # that run's shapes (K4: its last chunk)
    # and (this slice) at the ends 8, 16, 384 and 512: K1-fwd / K2 from
    # train-d{D}, K3 from its GQA training run, K4 from serve-d8
    # or its chunked generate; gpt-nano's own launches beside D = 8's
    hd = R["kernels-head-dims"]
    served = {128: R["serve-d128"], 8: R["serve-d8"]}
    fp = "vitrs_tpu/ops/flash_prefill.py:"
    for d in HD_NEW + HD_ENDS:
        counts, tres, gcounts, gres = R[f"train-d{d}"]
        serve = served.get(d)
        prefill = (serve["chunked_launches"] if serve
                   else gres["generate_launches"])["flash_prefill"]
        rows = (
            ("flash_fwd", fa + "567", [fa + "374"], counts, dict(
                train=tres, **({"serve": serve, "serve_launches":
                               serve["engine_launches"]} if serve
                               else {}),
                **({"nano": R["nano"][1], "nano_launches": R["nano"][0][
                    "flash_fwd"]} if d == 8 else {}),
                **({"small_build_edges": {e: hd[e] for e in HD_EDGE_ONLY}}
                   if d == 16 else {}),
                **({"large_build_checks": {e: hd[e] for e in HD_CHECK_ONLY}}
                   if d == 512 else {}))),
            ("flash_bwd", fa + "844", [fa + "986", fa + "901", fa + "418"],
             counts, {"kernels_per_launch": 3}),
            ("flash_gqa_fwd", fg + "358", [fg + "262"], gcounts,
             dict(train=gres)),
            ("flash_gqa_bwd", fg + "499", [fg + "538", fg + "470", fg + "309"],
             gcounts, {"kernels_per_launch": 3}),
            ("flash_prefill", fp + "123", [], {"flash_prefill": prefill}, {}))
        for kname, rep_, also, cnt, extra in rows:
            src = "flash_bwd.cu" if kname.endswith("bwd") else "flash_fwd.cu"
            check(cnt[kname] > 0, f"{kname} at D={d}: no launch on its path")
            kernels.append(dict(
                name=f"{kname}_d{d}", route="cuda", source=CSRC + src,
                replaces=rep_, also_replaces=also, head_dim=d,
                launches=cnt[kname], **extra, **hd[d][kname]))
    # GELU replaces no Pallas kernel: the JAX package's gelu_cv /
    # gelu_erf_cv are jnp that XLA fuses on the TPU; launches (forward,
    # backward) on the main paths: GPT-2 124M training, ViT-B/16 training
    # (its end-of-run evaluation included), vit-s-16 inference and the
    # engine (a layer a prefill pass and a decode tick)
    gpt_counts = R["train"][0]
    kernels.append(dict(
        name="gelu", route="cuda", source=CSRC + "gelu.cu", replaces=None,
        launches=[gpt_counts["gelu_fwd"], gpt_counts["gelu_bwd"]],
        vit_launches=[vit_counts["gelu_fwd"], vit_counts["gelu_bwd"]],
        infer_launches=[infer_counts["gelu_fwd"], infer_counts["gelu_bwd"]],
        serve_launches=[serve_counts["gelu_fwd"], serve_counts["gelu_bwd"]],
        **R["kernels-gelu"]))
    print("[smoke] context and expert parallelism: " + json.dumps(cpep))
    print("[smoke] tensor, sequence, vocab, pipeline and 3-D parallelism: "
          + json.dumps(tppp))
    print("[smoke] data-parallel families: " + json.dumps(
        {"meshes": meshes, "comm_nccl": R["comm-nccl"],
         "debug": R["debug"], "opcheck": sorted(ops["opcheck"])}))
    print("[smoke] reference-exact path: " + json.dumps(
        {"quirks": R["quirks"], "bitexact": R["bitexact"],
         "import_hf": R["import-hf"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
