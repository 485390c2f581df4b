#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py gspmd      # the build, then phase 13 alone
    python3 chip_smoke.py encdec     # the build, then phase 14 alone
    python3 chip_smoke.py roofline   # the build, then phase 15 alone
    python3 chip_smoke.py archs      # the build, then phase 16 alone
    python3 chip_smoke.py dryrun     # the build, phases 6 and 16(c), then 17

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit. In order:

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` each, all started together), then prints the registers
   and spills (``ptxas -v``) of the flash attention's 18 tensor-core
   kernels (forward, dq and dk/dv; bf16 and fp16; D 32, 64 and 128) and
   fails unless each one's SASS holds wgmma products (HGMMA) and TMA
   loads (UTMALDG) and no atomics, and unless the forward's six spill
   nothing; then those of the 36 split-KV decode kernels (dtype x D x
   rows a block) and the 3 combine kernels, and of the sampler's 6
   (dtype x 16-byte or scalar loads); then those of the CUDA-core flash
   kernels (fp32, and the MLA route's forward; fails unless the five
   (576, 512) ones are built), and of the MLA route's bf16/fp16 backward
   on the tensor cores (dq, dk/dv and the reduction, at (576, 512)):
   fails unless the six are built, dq and dk/dv hold HGMMA, none holds
   an atomic and none spills.
3. Kernels: calls each kernel's wrapper at the serve path's full-width
   llama3.2-1b shapes in bf16, holds it to its plain PyTorch version on
   the same inputs, and times the kernel, the plain version and one
   PyTorch library call as a yardstick, beside the least time the card
   could take (bytes over 3.35 TB/s or bf16 flops over 989 TFLOP/s).
   The training path's kernels (chunk_sum, the fp16 casts, fused_sgd,
   fused_rs_update) are held the same way at full-width AlexNet shapes:
   the f6.w bucket of 37,748,736 elements and its k=2 shard of
   18,874,368, against bytes over 3.35 TB/s. So are the blockwise int8
   quantizers (quant_int8, dequant_int8), which no path calls: a round
   trip through their wrappers on the f6.w bucket is their path (counts
   zeroed before it and read after), then each is held bit for bit to its
   plain version at that length and at 2,048,777, with an all-zero block
   and exact .5 ties, and timed (no PyTorch call computes the same
   function, so no library yardstick).
   The decode is the split kernel and the combine kernel (held alone to
   its plain version on partials whose dead chunks hold NaN); paged must
   equal contiguous at block_k = 16 and two calls must agree, bit for
   bit. The serve path's flash kernels are also held to their plain
   versions at head dim 128 (qwen1.5-4b's 20 heads over 20) in bf16, fp16
   and fp32: the prefill chunk and the decode, contiguous and paged,
   timed beside their D-64 times; the decode over 8 K lanes (8 slots at
   positions up to 8191: many chunks a lane), timed beside SDPA; every
   flash entry at head dims 16, 48 and 96 (zero-padded by the wrappers to
   32, 64, 128) in bf16; the sampler, bit for bit, at qwen1.5-4b's vocab
   of 151,936 as at llama3.2-1b's 128,256, at the decode's (8, 1, V) and
   the prefill tail's (1, 32, V), each shown by ``torch.profiler`` to be
   one operation on the card and timed beside an argmax of its selected
   rows, with its plan (CL blocks a slot, the slice of each); and the
   same at DeepSeek-V2-Lite's vocab of 102,400.
4. Engine: serves 16 requests through the port's ``Engine`` on full
   llama3.2-1b (16 layers, random weights from a seeded generator, bf16):
   paged KV cache, fused sampling, chunked prefill, a shared-prompt
   prefix hit. The launch counts are zeroed just before and read just
   after, and every kernel of the path must have launched; one decode
   step's host ms and device operations are printed (``python3
   chip_smoke.py serve`` builds the kernels and runs this llama3.2-1b
   engine alone, to compare two trees' host time). A short
   ``page_size=0`` pass reaches the contiguous ``flash_decode``. Three
   prompts' teacher-forced prefill and decode logits through the kernels
   are held to the einsum path, each printed beside its distance from
   the kernels in fp32. Then the same for qwen1.5-4b at full width cut
   to 20 of its 40 layers (d_model 2560, 20 heads of 128 over 20 KV
   heads, QKV bias,
   vocab 151,936): the flash kernels at head dim 128 and G = 1.
   The flash backward's two kernels (dq, and dk/dv) are held to their
   plain version at the LM training shapes (B 4, S 1024, 32 heads over 8,
   D 64, bf16), in fp32 at a smaller shape, and at G = 3 over a ragged
   S = 1000 (with the forward), and timed beside PyTorch's own flash
   backward; two backward calls at the LM shapes must agree bit for bit,
   and the order in which the flat grids launch their blocks is printed.
   At head dim 128 the forward and the backward are held the same way at
   B 2, S 1024, 20 heads over 20 and 64 over 8 (bf16 and fp16) and in
   fp32 at a smaller shape, two backward calls must agree bit for bit,
   and their times are printed beside the D-64 ones. A gradient check
   runs ``decoder_loss`` of full llama3.2-1b on 2 x 512 tokens through
   the kernels and through the einsum attention, and the same for
   qwen1.5-4b at full width, its depth cut to 4 layers.
5. Train: the paper's BSP training of full-width AlexNet (227 px, 1000
   classes, 60,965,224 parameters, fp32, TF32 off) on k=2 gloo rank
   processes that share the card; each rank takes batches of 128
   ``ImageSource`` images through the ``ParallelLoader`` (235 px cropped
   to 227), momentum SGD 0.9, weight decay 5e-4, the launcher's
   ``recipe`` (``warmup_cosine``) as for every convnet. Three
   runs of 4 steps: (a) ``asa16`` with the sharded update (the
   ``fused_rs_update`` kernel), (b) ``asa16`` unsharded with
   ``sgd_momentum(fused_kernel=fused_sgd)`` (``chunk_sum``, the fp16
   casts, ``fused_sgd``), (c) ``asa8`` sharded (the int8 variant). Each
   run's launch counts are zeroed just before it and read just after,
   and must equal what its bucket plan predicts; every loss must be
   finite; and one ``asa`` step of the two ranks on two halves of a batch
   must equal one step of a group of one on the whole batch.
   The same phase trains the paper's GoogLeNet (224 px, 1000 classes,
   both aux heads, 11,543,272 parameters; batch 32 a rank): (a) ``asa16``
   sharded with the fused tail, 3 steps, (b) ``ring16`` unsharded with
   ``fused_sgd``, 2 steps, and the k=2 = k=1 check to 1e-7; and VGG-16
   (224 px, 138,357,544 parameters; batch 16 a rank): ``asa16`` sharded,
   2 steps. Each prints its rate, step split, staging and peak memory a
   rank; its launches must equal the prediction.
6. LM train: BSP training of llama3.2-1b at full width cut to 4 of its
   16 layers (505,956,352 parameters, bf16 compute over fp32 masters,
   remat) on k=2 gloo ranks sharing the card: batches of 4 x 1024 ``LMTokenSource`` tokens a rank
   through the ``ParallelLoader``, ``asa16`` with the sharded update (the
   fused RS tail), momentum SGD 0.9, weight decay 1e-4, ``warmup_cosine``,
   4 steps, per-program attribution on (the launcher's default, so the
   exchange halves run after the first step) and ``REPRO_PEAK_FLOPS``
   set. The launch counts (flash forward twice a layer and step under
   remat, dq and dk/dv once, the wire and update kernels as the bucket
   plan says, the halves' casts and sums) must equal the prediction and
   every loss must be finite.
   At the smoke config the ranks then check that one fp32 ``asa`` step on
   two halves equals one step of a group of one on the whole batch, and
   that a run saved at step 3 and resumed to 6 equals an unbroken 6-step
   run bit for bit.
7. Training kernels at the paths' own shapes: at every (padded, shard)
   bucket shape that the LM, AlexNet, GoogLeNet and VGG-16 runs reported,
   ``quant_fp16`` / ``dequant_fp16`` (whole buckets, chunks and single
   shards, at either end of a bucket, as a ring hop casts them) and
   ``fused_rs_update`` equal their plain versions bit for bit (at the LM's
   and AlexNet's buckets also on the overlap's fp32 receive), and so
   does ``fused_sgd`` at every leaf and shard shape of the convnets.
8. Async, overlap and hier training (the paper's §4 and §3.2; it runs
   after phase 6, before phase 7's checks), on gloo ranks sharing the
   card, full-width models with random weights from a seeded
   generator: ``easgd`` at alpha 0.5 and tau 1, 2, 4 and
   ``asgd`` at tau 2 on full AlexNet (k = 2, 128 images a rank, the
   centre on ``asa16``, ``fused_sgd`` every step), 4 steps each, each
   printed with images/s, the mean local and sync step (its exchange and
   staging) and the engine's wire bytes a step; the exchange kernels must
   launch on the sync steps alone, as the bucket plan predicts, and a
   local step must move no staged byte. ``overlap="buckets"`` (2
   microbatches) beside the microbatched sharded step on full AlexNet (2
   x 64 images, 4 steps) and llama3.2-1b at full width cut to 2 of its 16
   layers (2 x (2 x 1024) tokens, 2 steps), each with its step split, the
   exposed exchange (the timer's exchange and the host's wait) against
   the collectives' whole time,
   staged MB, rate and launches (m x the RS kernels, one
   fused_rs_update a bucket). ``hier16`` sharded and ``hier`` unsharded
   on full AlexNet, 4 ranks as 2 pods of 2, 32 images a rank, 2 steps,
   the cross-pod leg's time apart. At the smoke config (fp32, cuDNN
   off): ``asgd`` at tau 1 equals BSP at k x the lr (rtol 1e-5, atol
   1e-6), an ``easgd`` tau-2 run saved at step 3 and resumed to 6 equals
   the unbroken run bit for bit, the overlapped step equals the
   microbatched one and k = 2 equals k = 1, and a ``hier`` step of 4
   ranks on quarters equals a group of one on the whole batch (1e-6).

9. Elastic training (the paper's §4 lineage; it runs after phase 8):
   ``repro_torch.fault.elastic.elastic_train`` on 4 gloo slot processes
   sharing the card, full AlexNet (random weights from a seeded
   generator, fp32, TF32 off), 32 images a worker, batch
   (step + row) mod 4 of a pool of 4 that a slot draws once,
   ``easgd`` alpha 0.5, tau 4, quorum 2, the centre on
   ``asa16``, momentum 0.9 through ``fused_sgd``, the launcher's
   ``recipe``, 40 steps of the reference smoke's chaos spec (kill,
   straggle, corrupt, drop, rejoin). Prints images/s, the mean local step
   and synced round (exchange, staging), each rebuild's parts (the new
   group, the centre broadcast to the joiner, its optimizer.init), the
   counts and the round log, and slot 0's peak memory. Fails unless the
   counts are the reference's, the step-23 round weighs (0.5, 0, 1/6)
   over (0, 2), every loss is finite, every live step of every slot
   launches what the bucket plan predicts at that step's k (the exchange
   kernels on synced rounds alone, weight 0 included), an idle slot
   launches nothing, and a local step moves no transport counter. Then,
   in the same processes, the fault smoke's properties at its config
   (``repro_torch.fault.smoke``: clean, chaos in the clean band, bitwise
   replay, preempt at 26 and resume into the band), and
   ``python -m repro_torch.telemetry.validate`` on slot 0's metrics
   JSONL and trace. After every path has run, the centre exchange's
   kernels (``quant_fp16``, ``chunk_sum``, ``dequant_fp16``) are held
   bit for bit to their plain versions at its buckets at k = 3 and
   k = 4, the k of its synced rounds.

10. Serve chaos (it runs after phase 4's engine runs): first the split-KV
   decode, contiguous and paged, at the chaos shape alone (4 slots over
   64-key lanes, pages of 8, 32 heads over 8, D 64, bf16) against its
   plain version. Then ``repro_torch.serve.chaos`` drives the port's
   ``Engine`` over full llama3.2-1b (random weights from a seeded
   generator, bf16) at the reference CLI's engine shape (4 slots,
   ``max_seq`` 64, prefill chunk 8, pages of 8, queue 16,
   ``reject-no-deadline``), with fused sampling, under the CLI's plan
   ``qflood:6@3,stall:8@6x4,cancel:1@9,pagepress:12@10x8`` at seed 0 and
   8 base requests, on the virtual clock: ``verify_replay`` (two runs,
   one digest; the allocator passes ``check_consistency`` after each),
   then ``verify_drain_restore`` (greedy tokens after drain -> restore
   equal to an uninterrupted run's). Prints the counts, the step log's
   length, the brownout levels reached, wall time, the host ms of a
   decode step and the path's launches (counted from zero around it).
   Fails unless the counts are the reference CLI's (they depend on
   neither the tokens nor the vocabulary), the decode saw one argument
   signature, goodput is at least the CLI's floor of 20 tokens, every accepted request reached a
   terminal state, and every kernel of the path launched. Then each
   kernel wrapper is held to its plain version on the arguments of its
   first call at each shape on the path.

11. DeepSeek-V2-Lite (MLA + fine-grained MoE; it runs after phase 10,
   before the gradient checks and the training phases, and frees the
   card back to the memory it started from; its wall time is printed):
   (a) the flash forward, dq and dk/dv on the MLA route (the absorbed
   layout: 16 heads over one KV head, Dk 576, Dv 512) held to their
   plain versions at B 2, S 1024 in bf16 and fp16, at a smaller shape in
   fp32 (the CUDA-core backward) and at a ragged S = 1000 with a window
   of 300 in bf16 and fp16, two backward calls bitwise equal in bf16 and
   fp16 (no atomics); the dk/dv plan printed (chunks, live blocks and
   their q tiles in launch order); the tensor-core dk/dv's reduction
   alone equal to its plain version bit for bit on partials whose dead
   chunks hold NaN; each of the four timed from a CUDA graph with the L2
   flushed beside its bound (bf16 tensor-core peak, the reduction's
   bytes; the CUDA cores' fp32 peak, the forward's route, printed beside
   it), its plain version and SDPA on the same q/k/v (the kernels SDPA
   ran are printed), and dq + dk/dv beside SDPA's backward (phase 3
   holds the sampler at the model's vocab of 102,400);
   (b) ``decoder_loss`` of the full-width model cut to 2 layers
   (the dense first and one MoE layer) on 2 x 512 tokens through the
   kernels and through the einsum attention: loss within GRAD_LOSS_TOL,
   each leaf's gradient within GRAD_TOL, the routed experts' and the
   router's within MOE_GRAD_TOL; (c) BSP training of that cut on k = 2
   gloo ranks sharing the card, bf16 over fp32 masters with remat, 2 x
   1024 tokens a rank, ``asa16`` sharded, 2 steps: launches equal to the
   prediction (the MLA forward twice a layer and step, dq, dk/dv and
   its reduction once, the wire and update kernels as the bucket plan
   says), losses and the
   MoE aux finite, the aux above 0; tokens/s, the step split and peak
   memory a rank printed; (d) the model at full width cut to 9 of its 27
   layers (the dense first and 8 MoE layers, 5,317,629,952 parameters;
   random bf16 weights from a seeded generator on the card)
   through the ``Engine`` with phase 4's traffic, the decode's MoE drop-
   free: decode tok/s, p50/p99, one decode step's host ms and device
   operations, peak memory; ``slot_gather_sample`` must launch, request 0
   (greedy) served alone must get the tokens it got beside 7 others, and
   a short ``page_size=0`` pass must finish.

12. The state-space and early-fusion decoders (it runs after phase 11,
   and frees the card back to the memory it started from; its wall time
   is printed): (e) the split-KV decode, contiguous and paged, and its
   combine at Hymba's decode (8 slots at positions up to 2047 over 2 K
   lanes, 25 heads over 5, D 64, a 1024-key window, bf16) and the forward
   at Hymba's windowed prefill chunk (128 queries at 1280), each held to
   its plain version and timed beside SDPA and its bound (phase 3 holds
   the sampler at Hymba's vocab of 32,001, the scalar loads, and
   Mamba2's 50,280, at the decode's (8, 1, V) and the prefill tails'
   (1, 32 or 128, V)); (a) mamba2-1.3b at full width cut to 24 of its
   48 SSD blocks (826,331,648 parameters), random bf16 weights from a
   seeded
   generator) through the ``Engine`` with phase 4's traffic: 8 slots of
   fp32 SSM state, no attention to page (the slot-granular pool),
   chunks rounded up to the SSD chunk of 128; decode and prefill tok/s,
   p50/p99, one decode step's host ms and device operations; only the
   sampler launches; request 8 through a reused slot equals a fresh
   engine's; (b) hymba-1.5b at full width cut to 16 of its 32 layers
   (871,894,560 parameters; layers 0 and 15 global)
   the same, its attention paged in pages of 16 beside the SSM lanes,
   no prefix cache, plus two requests of 1100-1500 prompt tokens at
   ``max_seq`` 2048 that carry the sliding layers past their window, and
   a contiguous pass that reaches ``flash_decode``; (c) for each, the
   teacher-forced prefill (chunks of 128) and 4 decode steps of two
   prompts (hymba: 256 and 1152 tokens) through the kernels in bf16 held
   to the einsum attention (hymba) or to the same path in fp32 (mamba2,
   no attention), each beside its distance from fp32, and a prompt
   prefilled in chunks held to one call (fp32; bf16 printed); (d) the
   gradient checks of hymba-1.5b at full width cut to 3 layers (1 x 1024
   tokens after its 128 meta tokens, so layer 1's window cuts) and
   chameleon-34b cut to 2 layers (1024 image embeddings of width 8192
   before 512 tokens), launches equal to the prediction.

13. Sharded (GSPMD/FSDP) training (it runs after phase 9; ``python3
   chip_smoke.py gspmd`` builds the kernels and runs it alone), on 2
   gloo ranks sharing the card: (a) llama3.2-1b at full width cut to 2
   of its 16 layers (bf16 over fp32
   masters, remat) on the LM phase's batches (4 x 1024 tokens a rank),
   momentum SGD 0.9 with ``fused_sgd``, 2 steps each of gspmd ``zero1``,
   gspmd ``ar`` and BSP ``asa`` with the sharded update (the fp32
   fused RS tail), each printed with tokens/s, its step split, staged MB
   a step and peak memory a rank, launches equal to the prediction;
   zero1 held to ar and to BSP (each rank on its own shards) and to
   gspmd at k=1 on the global batches (rank 0, a group of one) at
   ``GSPMD_REL`` of the run's largest movement, and one fp32 gspmd step
   of each mode at the smoke config, k=2 on halves vs k=1 on the batch,
   at ``K_TOL``; (b) qwen1.5-4b at full width cut to 2 of its 40 layers
   (936,537,600 parameters), gspmd zero1, 1 x 1024 tokens a rank, 2 steps, after a
   printed reckoning of what replicated BSP would need for the whole
   model against the card: its first loss held to a
   k=1 forward of the same parameters, its peak memory a rank printed;
   (c) ``chunk_sum`` on the largest gather's fp32 receive and
   ``fused_sgd`` on the largest shard of each model (and at every
   distinct shard shape, bit for bit), and the flash forward and
   backward at qwen1.5-4b's training shape (1 x 1024, 20/20 heads, D
   128), each held to its plain version and timed; their launches are
   the phase's paths' own.

14. The encoder-decoder (it runs after phase 13; ``python3 chip_smoke.py
   encdec`` builds the kernels and runs it alone), seamless-m4t-large-v2
   (24 encoder and 24 decoder layers, d_model 1024, 16 heads of 64,
   vocab 256,206, 4096 stub frames): (a) the model at full width cut to
   12 + 12 layers (1,279,748,096 parameters; the whole model's
   2,034,783,232 by ``param_count`` is checked; random fp32 masters from
   a seeded generator, bf16 compute) decodes 4 requests: ``prefill`` runs the
   encoder once and writes each layer's cross K/V (its bytes printed
   beside the reckoning), 16 prompt tokens go through ``decode_step``,
   then 32 greedy tokens, launches counted from zero around that run
   (``flash_decode`` and its combine, a layer and step); teacher-forced
   on those tokens, the kernels are held to the einsum attention in fp32
   at FP32_LOGIT_TOL of the largest logit and in bf16 at twice the
   einsum route's distance from its fp32 run; ``generate`` equals the
   decode loop from a zero cross cache bit for bit (it never runs the
   encoder, as the reference's); the encoder's ms, a decode step's host
   and device ms and operations, and peak memory printed; (b) the
   gradient check at full width cut to 2 + 2 layers on 2 x 1024 tokens
   after 4096 frames: the kernels in bf16 against the einsum route in
   bf16 and in fp32 at GRAD_TOL, in fp32 against it in fp32 at
   GRAD_TOL_FP32, every leaf printed; (c) BSP through the launcher's
   config, batches (the reference launcher's frames), loader and recipe
   on 2 gloo ranks sharing the card, both stacks cut to 2 layers
   (650,551,296 parameters), 2 x 1024 tokens and 2 x 4096 frames a rank,
   ``asa16`` sharded, 3 steps, after a printed reckoning of the whole
   model's training state: tokens/s and frames/s, the step split, staged
   MB and peak memory a rank, launches equal to the prediction, finite
   losses, and one fp32 step of k=2 on halves equal to k=1 at K_TOL;
   then the same config, batches and recipe under gspmd ``zero1`` for 2
   steps: finite losses, the first BSP's bit for bit and the second
   within GSPMD_LOSS_RTOL of it, the shards and peak a rank printed;
   (d) the flash forward, dq and dk/dv at (2, 1024, 16/16, D 64) bf16,
   ``flash_decode`` and its combine at (a)'s 48-key lanes, the wire and
   update kernels at (c)'s largest bucket and small leaf, each held to
   its plain version and timed, then at every bucket and small-leaf
   shape bit for bit.
15. The roofline and per-program attribution (it runs last; ``python3
   chip_smoke.py roofline`` builds the kernels and runs it alone, with
   the rows of its paths' kernels timed as phases 3 and 6 time them):
   prints ``roofline.analysis.peaks()`` beside the card's name and power
   limit; (a) a bf16 8192^3 cuBLAS product counted by ``CostMode`` at
   exactly 2 * 8192^3 flops and 3 * 8192^2 * 2 bytes, and timed; (b) each
   hand kernel launched at its PERF.md §6 shape under a ``CostMode``: the
   counted flops and bytes equal its cost function's, whose bound equals
   the table's to the digits the table shows; (c) phase 6's profiled
   run of llama3.2-1b at 4 layers (2 gloo ranks, 4 x 1024 tokens a rank,
   ``asa16`` sharded, 4 steps, ``REPRO_PEAK_FLOPS`` set; standalone, phase
   6 runs first): ``profile/train_step/*`` with 3 calls and
   ``compile/train_step_s``, the exchange halves (``exchange/rs``,
   ``exchange/ag``) counted and timed, the gauges ``train/model_flops_s``
   and ``train/mfu``, the step's count between 6·N·D and 1.1 (8·N·D +
   the attention kernels' flops); then the same run with profiling off:
   its four losses bit for bit phase 6's, its launches the prediction
   without the halves, no profile left; (d)
   full llama3.2-1b served with phase 4's traffic: ``serve/decode_step``
   and ``serve/prefill_chunk`` counted with the decode's, the combine's
   and the sampler's costs in them, the decode step's bytes at least the
   weights', one argument signature each. Every share (MFU, HBM and
   collective fractions; for (c) also their sum over the two ranks) must
   be at most SHARE_LIMIT; the launches of (c) and (d) join the kernels
   line. Phases 1-14 run at the launcher's defaults, attribution on: a
   program's first call is its counted call, and each training run that
   exchanges runs the exchange halves alone after its first step, whose
   launches its prediction counts (``_halves_launches``).
16. Every assigned decoder on the card (it runs last; ``python3
   chip_smoke.py archs`` builds the kernels and runs it alone), at full
   width with random weights from a seeded generator, each run after a
   printed reckoning of its memory: (a) minitron-8b whole (32 layers,
   vocab 256,000, 32 heads over 8), mistral-large-123b at 12 of 88 layers
   (vocab 32,768, 96 heads over 8: G 12) and llama4-scout-17b-a16e at 6
   of 48 (top-1 MoE over 16 experts and a shared one, vocab 202,048, 40
   over 8: G 5), bf16, through the ``Engine`` with phase 4's traffic:
   every kernel of the path launched (counts zeroed around the run), the
   sampler at (8, 1, V) and (1, 32, V) alone, a short ``page_size=0``
   pass that reaches ``flash_decode``, decode tok/s, p50/p99, one decode
   step's host ms and device operations, the peak; the teacher-forced
   check (``check_flash_vs_ref``; its fp32 runs take the weights cast to
   fp32 through the host); (d) llama4-scout's gradient check at 1 layer
   with 1024 image embeddings before 512 tokens (two ranks do not hold
   it); (c) on 2 gloo ranks sharing the card, one spawn, through the
   launcher's config, batch files, loader and recipe: mamba2-1.3b and
   hymba-1.5b BSP ``asa16`` sharded (2 x 1024 tokens a rank, 2 steps),
   minitron-8b, mistral-large-123b and chameleon-34b gspmd ``zero1`` (1 x
   1024 tokens a rank, 2 steps), each at the most layers up to a third of
   the model's (BSP) or 2 (gspmd) whose reckoning for the two ranks stays at
   or under 75 GB: finite losses, launches equal to the prediction, the first loss within GSPMD_LOSS_RTOL of a k=1
   forward's on the global batch (bit for bit or not printed), the peak a
   rank beside the reckoning, tokens/s and
   the step split; (b) the kernels at these shapes held to their plain
   versions and timed: the serve chunk and both decodes (with the
   combine) at each served model's heads, the sampler bit for bit at
   each served vocab, the flash forward, dq and dk/dv at the gspmd
   training shapes (1 x 1024, 32/8 and 96/8) and llama4-scout's gradient
   check (1 x 1536, 40/8), two backward calls bitwise equal, and the
   training kernels at (c)'s largest receive, shard and bucket, then at
   every shard and bucket bit for bit.
17. The dry run (``launch/dryrun.py``; it runs last, on this process's
   CPU: meta tensors in a fake world, no card; ``python3 chip_smoke.py
   dryrun`` builds the kernels and runs phases 6 and 16(c) first, whose
   measurements it holds to): (a) phase 6's LM run dry-run at mesh
   data=2: its flops, kernel costs and collectives by kind equal to what
   phase 6 counted for its first step on the card, its HBM bytes equal
   to the card's less the card's host copies (the gloo staging, listed
   kind by kind beside the transport's own count), the predicted peak a
   rank within DRYRUN_PEAK_TOL of the measured; (b) phase 16(c)'s five
   runs dry-run at their depths and batches, each predicted peak within
   DRYRUN_PEAK_TOL of the measured, printed beside the reckoning; (c)
   mistral-large-123b ``train_4k`` on the 16 x 16 mesh (fsdp with the
   model axis) ok, its memory, collectives and roofline printed. Its
   figures are predictions ("dry run, meta device, H100 SXM peaks").

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; with no CUDA device, or outside a checkout, it
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
ROOT = Path(__file__).resolve().parent

# tolerances against the plain versions on the card, and why
FWD_TOL = 1e-2        # bf16 output (eps 2^-8 ~ 3.9e-3) of |o| <~ 1 values;
                      # the kernel rounds p per key tile, the plain version
                      # once against the global row max
DECODE_TOL = 1e-2     # bf16 output, fp32 sums in another order
LOGIT_TOL = 0.1       # flash vs einsum logits, bf16 through 16 layers:
                      # the einsum path runs its softmax in bf16
QWEN_LOGIT_TOL = 0.15  # the same through qwen1.5-4b's 40 layers: on an
                       # H100 its 3 prompts x 6 calls read 0.094 at most,
                       # while each bf16 path lay 0.083 from the kernels in
                       # fp32 (the control printed beside it), so two
                       # correct bf16 paths may differ by up to ~0.17
FP32_LOGIT_TOL = 1e-3  # teacher-forced logits, the kernels vs the plain
                       # route both in fp32 (TF32 off), max |d| over the
                       # largest logit: only the order of sums differs.
                       # On an H100 80GB HBM3 at 700 W: 1.7e-6 (llama),
                       # 2.1e-6 (qwen), 2.5e-6 (hymba), 7.3e-6 (mamba2),
                       # while bf16 alone moves the logits 0.013-0.05 of
                       # the largest (the control, printed beside it)
QWEN_SERVE_LAYERS = 10  # qwen1.5-4b's engine run: full width, a quarter
                        # of its 40 layers (the script has 1200 s)
QWEN_GRAD_LAYERS = 4  # qwen1.5-4b's gradient check: full width, depth cut
                      # from 40 to 4 layers (three models' gradients of the
                      # 151,936 x 2560 embedding and head fit beside the
                      # engine's leftovers; 4 layers reach every kernel)
UPDATE_TOL = 0.0      # training kernels: they add rows in the plain
                      # version's order and round every product and sum on
                      # its own (no FMA), so they are held bit for bit
K_TOL = 1e-6          # one asa step, k=2 ranks on two halves vs a group of
                      # one on the whole batch, max |dp|: in full fp32
                      # (TF32 and cuDNN off) the gradients differ only by
                      # summation order (~1e-6 of |g|, so ~1e-8 at lr 0.01),
                      # and p - lr g rounds to 1 ulp of |p| < 1 (<= 1.2e-7)
K_TOL_GOOGLENET = 1e-7   # the same for GoogLeNet (|p| < 1 there, so one
                         # ulp of the update is <= 6e-8)
GOOGLENET_PARAMS = 11_543_272   # at 224 px: aux fc1 sized for the 3x3 map
                                # the forward makes (the paper: 13,378,280)
BWD_TOL = 2e-2        # flash dq/dk/dv at bf16, max |d| over the output's max
                      # |plain|: both versions round ds and p to bf16 per
                      # element but sum them in another order, and ds carries
                      # the cancellation of dp - di
BWD_TOL_FP32 = 1e-5   # the same in fp32: only the order of the sums differs
GRAD_LOSS_TOL = 1e-2  # full-width decoder_loss, kernels vs einsum attention:
                      # bf16 activations through 16 layers; the einsum path
                      # takes its scores and softmax in bf16, the kernels in
                      # fp32
GRAD_TOL = 5e-2       # each leaf's gradient there, relative Frobenius error:
                      # 16 layers of d_model 512 under the same bf16 policy
                      # measured 2.5e-2 (max) and 1.5e-2 (median) on the CPU
                      # with the plain versions, the attention projections
                      # the worst, while each side lay 2.7e-2 / 2.8e-2 from
                      # the kernels in fp32 (printed here too): the bf16
                      # policy, not the kernels, sets the disagreement.
                      # qwen1.5-4b cut to 4 layers of d_model 2560 (D 128,
                      # G 1) read 2.4e-2 (max) on an H100, each side 2.2e-2
                      # / 2.6e-2 from fp32: the same policy, the same limit
GRAD_TOL_FP32 = 1e-3  # the same in fp32, kernels vs einsum attention: only
                      # the order of the sums differs, so a kernel fault
                      # shows far above it
LM_STEPS = 4          # steps of the LM training run
LM_BATCH, LM_SEQ = 4, 1024   # sequences of tokens per rank and step
LM_LAYERS = 4                # of llama3.2-1b's 16, full width (the script
LM_PARAMS = 505_956_352      # has 1200 s); tied embeddings


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _median_ms(fn, iters: int = 30, flush=None) -> float:
    """Median device time of one call in ms. The call is captured once in
    a CUDA graph and replayed between CUDA events, so the time is the
    card's and not the host's dispatch of it; ``flush`` runs (untimed)
    before each replay to empty the L2 cache, as a serve step finds it."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()                                    # warm-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def _host_ms(fn, iters: int = 30) -> float:
    """Median wall time of one call including the host's dispatch, ending
    in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_b, t_f = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _event_ms(fn, iters: int = 20, flush=None) -> float:
    """Median device time of one call launched from the host (for a
    library call that cannot be captured in a CUDA graph)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


HOPPER = re.compile(r"fwd_hopper|bwd_d(?:q|kv)_hopper")
HOPPER_KERNELS = 18     # forward, dq, dk/dv x bf16, fp16 x D 32, 64, 128


def _ptxas(log: str, pattern: str):
    """(mangled name, {registers, spill_stores, spill_loads}) of each kernel
    whose name matches ``pattern`` in a ``ptxas -v`` log."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and re.search(pattern, m.group(1)):
            props = " ".join(lines[n + 1:n + 4])
            yield m.group(1), dict(
                registers=int(re.search(r"Used (\d+) registers", props).group(1)),
                spill_stores=int(re.search(r"(\d+) bytes spill stores", props)
                                 .group(1)),
                spill_loads=int(re.search(r"(\d+) bytes spill loads", props)
                                .group(1)))


def _dtype_label(mangled: str) -> str:
    return ("bf16" if "bfloat16" in mangled else "fp16" if "__half" in mangled
            else "fp32")


def _kernel_label(mangled: str) -> str:
    """``bwd_dq_hopper<bf16, 64>`` from a mangled kernel name."""
    return (f"{HOPPER.search(mangled).group(0)}<{_dtype_label(mangled)}, "
            f"{re.search(r'Li(\d+)E', mangled).group(1)}>")


def hopper_build_report(K):
    """The flash forward's and backward's tensor-core kernels as built:
    registers and spills (``ptxas -v``), and in their SASS the wgmma
    products (HGMMA), the TMA loads (UTMALDG) and no atomics (ATOM*,
    RED). The forward kernels must not spill."""
    regs = {_kernel_label(name): r for name, r in _ptxas(
        K.build_log("flash_attention"), HOPPER.pattern)}
    print("flash tensor-core kernels, ptxas: " + json.dumps(regs))
    ops = {_kernel_label(n): c for n, c in K.sass_ops(
        "flash_attention", HOPPER.pattern).items()}
    print("flash tensor-core kernels, SASS instructions: " + json.dumps(ops))
    if len(regs) != HOPPER_KERNELS or sorted(ops) != sorted(regs) or not all(
            o["HGMMA"] > 0 and o["UTMALDG"] > 0 and o["atomics"] == 0
            for o in ops.values()):
        _fail(f"the {HOPPER_KERNELS} bf16/fp16 flash kernels must be built "
              f"with wgmma and TMA loads and no atomics")
    spills = {n: r for n, r in regs.items() if n.startswith("fwd_hopper")
              and r["spill_stores"] + r["spill_loads"] > 0}
    if spills:
        _fail(f"the flash forward kernels spill: {spills}")


def decode_build_report(K):
    """Registers and spills (``ptxas -v``) of every decode instantiation
    (dtype x head dim x rows a block) and of the combine kernel. Returns
    {label: {registers, spill_stores, spill_loads}}."""
    out = {}
    for name, r in _ptxas(K.build_log("flash_attention"), "decode"):
        kind = "decode_combine_kernel" if "combine" in name else "decode_kernel"
        ints = re.findall(r"Li(\d+)E", name)
        out[f"{kind}<{', '.join([_dtype_label(name)] + ints)}>"] = r
    spills = sum(r["spill_stores"] + r["spill_loads"] for r in out.values())
    print(f"flash decode kernels, ptxas ({len(out)} kernels, {spills} bytes "
          f"of spills): " + json.dumps(out))
    if not out:
        _fail("no decode kernel in the flash_attention build log")
    return out


def sampler_build_report(K):
    """Registers and spills (``ptxas -v``) of the sampler's six kernels
    (dtype x 16-byte or scalar loads, the W in ``sample_kernel<T, W>``).
    Returns {label: {registers, spill_stores, spill_loads}}."""
    out = {}
    for name, r in _ptxas(K.build_log("slot_gather"), "sample_kernel"):
        width = re.search(r"Li(\d+)E", name).group(1)
        out[f"sample_kernel<{_dtype_label(name)}, {width}>"] = r
    print("slot_gather_sample kernels, ptxas: " + json.dumps(out))
    if len(out) != 6:
        _fail(f"expected 6 sampler kernels in the slot_gather build log, "
              f"found {len(out)}")
    return out


def _bwd_grid_order(B, S, H, KV, tile=64):
    """Live tiles per block of the tensor-core backward at a causal shape
    (q_off 0, no window), in launch order, as csrc/flash_attention.cu lays
    the flat grid out: dk/dv's block n takes key tile n // (KV * B), dq's q
    tile nq - 1 - n // (KV * B), so the blocks with the most work go first.
    Returns {kernel: [live tiles of each (kv head, batch) round]}."""
    bq = tile // (H // KV)
    nq, nk = -(-S // bq), -(-S // tile)
    return {"dkv": [nq - max(0, -((bq - 1 - tile * j) // bq))
                    for j in range(nk)],
            "dq": [min(nk - 1, (min((i + 1) * bq, S) - 1) // tile) + 1
                   for i in reversed(range(nq))]}


def _serve_flash(torch, ref, fa, g, H, KV, D, dtype, flush=None, dev="cuda"):
    """The serve path's flash kernels at one head layout and dtype, each
    held to its plain version: a 32-query prefill chunk at the end of a
    1 K lane (with its lse), and the one-token decode of 8 slots at
    positions 64..1000 over 1 K lanes with its combine (_serve_decode).
    With ``flush``, each kernel's time beside its plain version's, the
    library call's and its bound. Returns {kernel name: row}."""
    import torch.nn.functional as F
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else None
    es = torch.finfo(dtype).bits // 8                # bytes a value
    scale = 1 / math.sqrt(D)
    src = "src/repro_torch/csrc/flash_attention.cu"
    label = f"{H}/{KV} heads, D {D}, {str(dtype)[6:]}"

    # --- flash_attention: one 32-row prefill chunk at the end of a 1 K lane
    B, Sq, Sk = 1, 32, 1024
    q, k, v = rn(B, Sq, H, D), rn(B, Sk, KV, D), rn(B, Sk, KV, D)
    q_off = torch.tensor([Sk - Sq], dtype=torch.int32, device=dev)
    got, lse = fa.flash_attention(q, k, v, q_off=q_off, return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, 0, scale, True)
    err = (got.float() - want.float()).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    if not (err <= (tol or FWD_TOL) and err_l <= 1e-3):
        _fail(f"flash_attention ({label}) vs plain: max err {err}, lse "
              f"{err_l}")
    rows = {"flash_attention": dict(
        name="flash_attention", src=src,
        replaces="src/repro/kernels/flash_attention.py:97", err=err,
        lse_err=err_l)}

    rows.update(_serve_decode(torch, ref, fa, g, H, KV, D, dtype, flush,
                              SERVE_POSITIONS, 1024, dev))
    if flush is None:
        return rows
    qpos = torch.arange(Sq, device=dev) + int(q_off)
    mask = (torch.arange(Sk, device=dev)[None] <= qpos[:, None])
    keys = int((qpos + 1).clamp(max=Sk).sum())          # live (row, key) pairs
    live_rows = min(int(q_off) + Sq, Sk)
    fn = lambda: fa.flash_attention(q, k, v, q_off=q_off)
    rows["flash_attention"].update(
        ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
        plain_ms=_median_ms(
            lambda: ref.flash_attention_ref(q, k, v, q_off, 0, scale),
            flush=flush),
        library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), flush=flush),
        bound=_bound(2 * q.numel() * es + 2 * live_rows * KV * D * es + 4 * B,
                     4 * D * H * keys))
    return rows


SERVE_POSITIONS = (64, 200, 333, 480, 512, 700, 871, 1000)  # 8 slots, 1 K lanes
LONG_POSITIONS = (0, 511, 1024, 2047, 4095, 5000, 7777, 8191)  # 8 K lanes


def _serve_decode(torch, ref, fa, g, H, KV, D, dtype, flush, positions, S,
                  dev="cuda", ps=16, window=0):
    """The one-token decode of len(positions) slots over lanes of S keys,
    contiguous and paged (pages of ``ps``, a random page table, the null
    page past each position), held to the plain version; paged equal to
    contiguous at block_k = ``ps`` bit for bit, and two calls equal bit for
    bit. The combine kernel held to its plain version on the plain
    version's chunk partials, its dead chunks poisoned with NaN. With
    ``flush``, each kernel's time beside its plain version's, SDPA's
    (contiguous) and its bound. ``window`` > 0 limits each slot to its
    last ``window`` keys. Returns {kernel name: row}."""
    import torch.nn.functional as F
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else DECODE_TOL
    es = torch.finfo(dtype).bits // 8                # bytes a value
    scale = 1 / math.sqrt(D)
    src = "src/repro_torch/csrc/flash_attention.cu"
    label = f"{len(positions)} slots over {S} keys, {H}/{KV} heads, D {D}, " \
        f"{str(dtype)[6:]}, pages of {ps}" + (f", window {window}"
                                              if window else "")
    B = len(positions)
    NP = S // ps
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    qd = rn(B, 1, H, D)
    P = B * NP + 1                                    # + the null page 0
    kp, vp = rn(P, ps, KV, D), rn(P, ps, KV, D)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm.reshape(B, NP).contiguous()
    live = (torch.arange(NP, device=dev)[None] * ps <= pos[:, None].long())
    tables = torch.where(live, tables, 0).to(torch.int32)  # null page past pos
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    W = dict(window=window)
    got_c = fa.flash_decode(qd, lk, lv, pos, **W)
    want_c = ref.flash_decode_ref(qd, lk, lv, pos, window, scale, 512)
    err_c = (got_c.float() - want_c.float()).abs().max().item()
    got_p = fa.flash_decode_paged(qd, kp, vp, tables, pos, page_size=ps, **W)
    want_p = ref.flash_decode_paged_ref(qd, kp, vp, tables, pos, window,
                                        scale, ps)
    err_p = (got_p.float() - want_p.float()).abs().max().item()
    if not (err_c <= tol and err_p <= tol):
        _fail(f"flash decode ({label}) vs plain: max err {err_c} / {err_p}")
    if not torch.equal(got_p, fa.flash_decode(qd, lk, lv, pos, block_k=ps,
                                              **W)):
        _fail(f"flash_decode_paged != flash_decode(gathered, "
              f"block_k={ps}) ({label})")
    if not (torch.equal(got_c, fa.flash_decode(qd, lk, lv, pos, **W)) and
            torch.equal(got_p, fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                                     page_size=ps, **W))):
        _fail(f"two flash decode calls differ ({label})")

    # the combine, on the chunks the contiguous call makes
    chunk, ns = fa.decode_plan(S, fa.DEFAULT_DECODE_BLOCK_K, _sms(torch, dev))
    m, l, acc = ref.decode_partials_ref(qd, lk, lv, pos, window, scale, chunk)
    cj = torch.arange(ns, device=dev)[None]
    chunk_live = cj * chunk <= pos[:, None].long()          # (B, ns)
    if window:
        chunk_live &= (cj + 1) * chunk > pos[:, None].long() - window + 1
    dead = ~chunk_live[:, None, :, None]
    m, l = m.masked_fill(dead, float("nan")), l.masked_fill(dead, float("nan"))
    acc = acc.masked_fill(dead[..., None], float("nan"))
    comb = lambda: fa.decode_combine(m, l, acc, pos, chunk=chunk, kv_len=S,
                                     dtype=dtype, **W)
    comb_plain = lambda: ref.combine_live_splits(m, l, acc, pos, window,
                                                 chunk, S).to(dtype)
    err_m = (comb().float() - comb_plain().float()).abs().max().item()
    if not err_m <= tol:
        _fail(f"flash_decode_combine ({label}) vs plain: max err {err_m}")
    rows = {"flash_decode": dict(
                name="flash_decode", src=src,
                replaces="src/repro/kernels/flash_attention.py:391",
                err=err_c),
            "flash_decode_paged": dict(
                name="flash_decode_paged", src=src,
                replaces="src/repro/kernels/flash_attention.py:490",
                err=err_p),
            "flash_decode_combine": dict(
                name="flash_decode_combine", src=src,
                replaces="src/repro/kernels/flash_attention.py:474",
                err=err_m)}
    if flush is None:
        return rows

    kpos = torch.arange(S, device=dev)[None]
    dmask = kpos <= pos[:, None]
    if window:
        dmask &= pos[:, None] - kpos < window
    dmask = dmask[:, None, None]
    # visible keys, all slots
    need = int((pos.long() + 1).clamp(max=window or S).sum())
    dec_bytes = 2 * qd.numel() * es + 2 * need * KV * D * es + 4 * B
    dec_flops = 4 * D * H * need
    parts = int(chunk_live.sum()) * H           # live (chunk, query row) pairs
    calls = dict(
        flash_decode=(
            lambda: fa.flash_decode(qd, lk, lv, pos, **W),
            lambda: ref.flash_decode_ref(qd, lk, lv, pos, window, scale, 512),
            lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
                attn_mask=dmask, enable_gqa=True),
            _bound(dec_bytes, dec_flops)),
        flash_decode_paged=(
            lambda: fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                          page_size=ps, **W),
            lambda: ref.flash_decode_paged_ref(qd, kp, vp, tables, pos,
                                               window, scale, ps),
            None,                         # no single library call pages
            _bound(dec_bytes + int(live.sum()) * 4, dec_flops)),
        flash_decode_combine=(
            comb, comb_plain,
            None,                         # no single library call merges
            _bound(parts * (2 + D) * 4 + 4 * B + qd.numel() * es,
                   parts * 3 * D, FP32_FLOP_S)))
    for name, (fn, plain, lib, bound) in calls.items():
        rows[name].update(
            ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
            plain_ms=_median_ms(plain, flush=flush),
            library_ms=None if lib is None else _median_ms(lib, flush=flush),
            bound=bound)
    rows["flash_decode_combine"].update(chunk=chunk, chunks=ns)
    return rows


def _sms(torch, dev) -> int:
    return torch.cuda.get_device_properties(
        torch.device(dev)).multi_processor_count if str(dev) != "cpu" else 132


def _device_ops(torch, fn) -> int:
    """Operations one call of ``fn`` runs on the card (kernels, copies and
    sets, counted by ``torch.profiler``), after a warm-up call."""
    return _device_profile(torch, fn)[0]


def _device_profile(torch, fn) -> tuple:
    """(operations, their summed device ms) of one call of ``fn`` on the
    card, by ``torch.profiler``, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(ev.time_range.elapsed_us() for ev in evs) / 1e3


def _shape_key(name: str, shape) -> str:
    """A path's count of ``name``'s launches at ``shape`` (from
    ``K.LAUNCH_SHAPES``), as its launches dict keeps it."""
    return f"{name} {tuple(shape)}"


def _sampler_check(torch, ref, sg, g, S_, C, V, flush, dev="cuda",
                   count_ops=True):
    """slot_gather_sample at (S_, C, V) on the card held bit for bit to
    its plain version (half the slots greedy, half at temperature 0.8),
    with ``count_ops`` shown to be one operation on the card, and timed
    beside it and beside an argmax of the selected rows. The plan (CL
    blocks a slot, slice) comes with it."""
    tiny = torch.finfo(torch.float32).tiny
    lg = torch.randn(S_, C, V, generator=g, device=dev).to(torch.bfloat16)
    sel = torch.randint(0, C, (S_,), generator=g, device=dev)
    oh = torch.nn.functional.one_hot(sel, C).float()
    T = torch.tensor([0.8, 0.0] * 4, device=dev)[:S_]
    u = torch.rand(S_, V, generator=g, device=dev).clamp_min(tiny)
    nz = -torch.log(-torch.log(u))
    gk, sk = sg.slot_gather_sample(lg, oh, T, nz)
    gr, sr = ref.slot_gather_sample_ref(lg, oh, T, nz)
    if not (torch.equal(gk, gr) and torch.equal(sk, sr)):
        _fail(f"slot_gather_sample ({S_}, {C}, {V}) differs from plain")
    call = lambda: sg.slot_gather_sample(lg, oh, T, nz)  # noqa: E731
    ops = None if dev == "cpu" or not count_ops else _device_ops(torch,
                                                                   call)
    if ops not in (None, 1):
        _fail(f"slot_gather_sample ({S_}, {C}, {V}) runs {ops} operations "
              f"on the card, not one kernel")
    row = lg[torch.arange(S_, device=dev), sel]
    return dict(
        name="slot_gather_sample", src="src/repro_torch/csrc/slot_gather.cu",
        replaces="src/repro/kernels/slot_gather.py:37",
        err=float(max((gk - gr).abs().max().item(),
                      (sk - sr).abs().max().item())),
        plan=sg.sampler_plan(S_, C, V, _sms(torch, dev)), device_ops=ops,
        ms=_median_ms(call, flush=flush), host_ms=_host_ms(call),
        plain_ms=_median_ms(lambda: ref.slot_gather_sample_ref(lg, oh, T, nz),
                            flush=flush),
        library_ms=_median_ms(lambda: torch.argmax(row, -1), flush=flush),
        # the kernel reads only the one-hot-selected row of each slot
        bound=_bound(S_ * V * (2 + 4) + oh.numel() * 4 + S_ * 12, 3 * S_ * V))


def kernel_phase(torch, ref, fa, sg, flush):
    """Each serve kernel against its plain version at the serve path's
    shapes: llama3.2-1b's (32 heads over 8, D 64, vocab 128,256; the
    rows) and qwen1.5-4b's (20 over 20, D 128, vocab 151,936), the flash
    kernels there in every dtype they take; the sampler also at
    DeepSeek-V2-Lite's vocab of 102,400."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1234)
    flash = _serve_flash(torch, ref, fa, g, 32, 8, 64, torch.bfloat16, flush)
    rows = list(flash.values())

    # --- slot_gather_sample: decode (8, 1, V) and the prefill tail (1, 32, V)
    print("slot_gather_sample clusters the card holds at once, by blocks a "
          "cluster: " + json.dumps({cl: sg.clusters_at_once(cl)
                                    for cl in (4, 8, 16)}))
    zeros = torch.zeros(8, dtype=torch.int32, device=dev)
    print("timer floor: one trivial kernel (8 int32 set to 0) timed as the "
          f"kernels are, ms: {_median_ms(zeros.zero_, flush=flush)}")
    for V in (128256, 151936, 102400):   # llama3.2-1b, qwen1.5-4b, deepseek
        for S_, C in ((8, 1), (1, 32)):
            r = _sampler_check(torch, ref, sg, g, S_, C, V, flush)
            if (V, C) == (128256, 1):
                rows.append(r)
            print(f"slot_gather_sample ({S_}, {C}, {V}), equal to plain, "
                  f"library = argmax of these selected rows: " + json.dumps(
                      {k_: r[k_] for k_ in ("plan", "device_ops", "ms",
                                            "plain_ms", "library_ms",
                                            "host_ms", "bound")}))
    # phase 12's vocabularies (hymba-1.5b's 32,001, not a multiple of 8:
    # the scalar loads; mamba2-1.3b's 50,280), here where the profiler's
    # count of one operation holds (phase 11 notes why): the decode, the
    # 32-row tail and the SSM engines' 128-row prefill tail. The two shapes
    # those engines give it are rows of the kernels line, each counting
    # the path's launches at its own shape
    for V, arch in ((32001, HYMBA_ARCH), (50280, MAMBA_ARCH)):
        for S_, C in ((8, 1), (1, 32), (1, 128)):
            r = _sampler_check(torch, ref, sg, g, S_, C, V, flush)
            if C != 32:
                rows.append(dict(r, shape=f"({S_}, {C}, {V}) bf16",
                                 paths=("serve_" + arch,),
                                 count_key=_shape_key(r["name"],
                                                      (S_, C, V))))
            print(f"slot_gather_sample ({S_}, {C}, {V}), equal to plain, "
                  f"library = argmax of these selected rows: " + json.dumps(
                      {k_: r[k_] for k_ in ("plan", "device_ops", "ms",
                                            "plain_ms", "library_ms",
                                            "host_ms", "bound")}))

    # --- the flash kernels at head dim 128, G = 1
    g = torch.Generator(device=dev).manual_seed(128)
    errs = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        bf = dtype == torch.bfloat16
        d128 = _serve_flash(torch, ref, fa, g, 20, 20, 128, dtype,
                            flush if bf else None)
        errs[str(dtype)[6:]] = dict(
            {n: r["err"] for n, r in d128.items()},
            lse=d128["flash_attention"]["lse_err"])
        if bf:
            beside = {n: dict({k_: r[k_] for k_ in (
                "ms", "host_ms", "plain_ms", "library_ms", "bound")},
                ms_d64=flash[n]["ms"]) for n, r in d128.items()}
    print("flash kernels at D 128 (20 heads over 20), max |d| vs plain: "
          + json.dumps(errs))
    print("flash serve kernels at D 128, bf16, beside D 64 (llama3.2-1b "
          "shapes): " + json.dumps(beside))

    # --- the decode over 8 K lanes: many chunks a lane
    long = _serve_decode(torch, ref, fa, g, 32, 8, 64, torch.bfloat16, flush,
                         LONG_POSITIONS, 8192)
    print("flash decode over 8 K lanes (8 slots at positions up to 8191, "
          "32/8 heads, D 64, bf16): " + json.dumps(
              {n: {k_: r[k_] for k_ in ("err", "ms", "host_ms", "plain_ms",
                                        "library_ms", "bound")}
               for n, r in long.items()}))
    odd_head_dims(torch, ref, fa, g)
    return rows


ODD_HEAD_DIMS = (16, 48, 96)


def odd_head_dims(torch, ref, fa, g, dev="cuda"):
    """Every flash entry at head dims the kernels are not built for (the
    wrappers zero-pad them to the next of 32, 64, 128), in bf16, held to
    its plain version: the forward with lse and the backward at B 2, S
    300, 8 heads over 2, window 100, q_off (0, 17); both decodes and the
    combine at the serve shape (_serve_decode)."""
    dtype = torch.bfloat16
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dtype)
    errs = {}
    for D in ODD_HEAD_DIMS:
        B, S, H, KV, win = 2, 300, 8, 2, 100
        q, k, v, do = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D), \
            rn(B, S, H, D)
        qo = torch.tensor([0, 17], dtype=torch.int32, device=dev)
        scale = 1 / math.sqrt(D)
        out, lse = fa.flash_attention(q, k, v, q_off=qo, window=win,
                                      return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, qo, win, scale, True)
        e = dict(fwd=(out.float() - want.float()).abs().max().item(),
                 lse=(lse - want_lse).abs().max().item())
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=qo,
                                     window=win, sm_scale=scale)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, win,
                                            scale)
        e.update({n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                       got, wants)})
        if not (e["fwd"] <= FWD_TOL and e["lse"] <= 1e-3 and
                max(e["dq"], e["dk"], e["dv"]) <= BWD_TOL):
            _fail(f"flash at head dim {D} vs plain: {e}")
        dec = _serve_decode(torch, ref, fa, g, H, KV, D, dtype, None,
                            SERVE_POSITIONS, 1024, dev)
        errs[D] = dict(e, **{n: r["err"] for n, r in dec.items()})
    print(f"flash kernels at head dims {ODD_HEAD_DIMS} (padded to 32, 64, "
          f"128), bf16, max |d| vs plain (dq, dk, dv over max |plain|): "
          + json.dumps(errs))


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _check_bwd(torch, ref, fa, dtype, shape, tol, fwd_tol=None, seed=0,
               dev="cuda", window=0, twice=False):
    """The flash backward kernels (and, with ``fwd_tol``, the forward)
    against their plain versions at one causal shape (queries from
    position 0, on ``window`` keys; 0 = all) and, with ``twice``, a second
    backward call bitwise equal to the first; returns the inputs and the
    backward's errors, relative (``errs``, held to ``tol``) and absolute
    (``abs_errs``)."""
    B, S, H, KV, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dtype)
    q, k, v, do = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D), \
        rn(B, S, H, D)
    qo = torch.zeros(B, dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(D)
    label = f"{shape}{f' window {window}' if window else ''} {str(dtype)[6:]}"
    out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    if fwd_tol is not None:
        want, want_lse = ref.flash_attention_ref(q, k, v, qo, window, scale,
                                                 True)
        err = (out.float() - want.float()).abs().max().item()
        err_l = (lse - want_lse).abs().max().item()
        if not (err <= fwd_tol and err_l <= 1e-3):
            _fail(f"flash_attention {label}: max err {err}, lse {err_l}")
    bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=qo,  # noqa: E731
                                         window=window, sm_scale=scale)
    got = bwd()
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, window,
                                       scale)
    names = ("dq", "dk", "dv")
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, got, want)}
    abs_errs = {n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(names, got, want)}
    print(f"flash backward {label}: max |d| / max |plain| "
          + json.dumps(errs))
    if not all(e <= tol for e in errs.values()):
        _fail(f"flash backward {label} vs plain: {errs} > {tol}")
    if twice:
        same = all(torch.equal(a, b) for a, b in zip(got, bwd()))
        print(f"flash backward {label}, two calls bitwise equal: {same}")
        if not same:
            _fail(f"two flash backward calls at {label} differ")
    return dict(q=q, k=k, v=v, do=do, out=out, lse=lse, qo=qo, scale=scale,
                got=got, want=want, errs=errs, abs_errs=abs_errs)


def _library_bwd_ms(torch, q, k, v, do, flush):
    """PyTorch's own flash-attention backward (dq, dk, dv in one call) at
    the same shapes, K/V repeated to all H heads. A yardstick; the port
    never calls it."""
    G = q.shape[2] // k.shape[2]
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    o, lse, cq, ck, mq, mk, seed, off = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)[:8]
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    return _event_ms(lambda: bwd(dot, qt, kt, vt, o, lse, cq, ck, mq, mk,
                                 0.0, True, seed, off), flush=flush)


def _lm_flash(torch, ref, fa, flush, shape, seed, dev="cuda"):
    """The flash forward and backward in bf16 at one causal training
    shape held to their plain versions, two backward calls bitwise equal,
    and the forward's, dq's and dk/dv's times beside PyTorch's own calls
    and their bounds (dq and dk/dv beside their plain versions too).
    Returns ({"fwd", "flash_attention_dq", "flash_attention_dkv": row},
    the _check_bwd result)."""
    B, S, H, KV, D = shape
    c = _check_bwd(torch, ref, fa, torch.bfloat16, shape, BWD_TOL,
                   fwd_tol=FWD_TOL, seed=seed, dev=dev, twice=True)
    q, k, v, do, lse, qo, scale = (c[n] for n in ("q", "k", "v", "do", "lse",
                                                  "qo", "scale"))
    di = ref.flash_attention_di(c["out"], do)
    kw = dict(q_off=qo, window=0, sm_scale=scale)
    lib_ms = _library_bwd_ms(torch, q, k, v, do, flush)
    pairs = B * H * S * (S + 1) // 2           # live (row, key) pairs
    row_b, kv_b, st_b = B * S * H * D * 2, B * S * KV * D * 2, B * S * H * 4
    fwd = _bound(2 * row_b + 2 * kv_b + st_b, 4 * D * pairs)
    rows = {"fwd": dict(
        ms=_median_ms(lambda: fa.flash_attention(q, k, v, q_off=qo,
                                                 return_lse=True),
                      flush=flush),
        library_ms=_event_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), is_causal=True,
                                 enable_gqa=True), flush=flush),
        bound_ms=fwd[0], bound_by=fwd[1])}
    for name, line, fn, plain, nbytes, flops, outs in (
            ("flash_attention_dq", 179,
             lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dq_ref(q, k, v, lse, do, di, qo, 0,
                                                scale),
             3 * row_b + 2 * kv_b + 2 * st_b, 6 * D * pairs, ("dq",)),
            ("flash_attention_dkv", 214,
             lambda: fa.flash_attention_dkv(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dkv_ref(q, k, v, lse, do, di, qo, 0,
                                                 scale),
             2 * row_b + 4 * kv_b + 2 * st_b, 8 * D * pairs, ("dk", "dv"))):
        rows[name] = dict(
            name=name, src="src/repro_torch/csrc/flash_attention.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            err=max(c["abs_errs"][o] for o in outs),
            rel_err=max(c["errs"][o] for o in outs),
            ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
            plain_ms=_median_ms(plain, flush=flush), library_ms=lib_ms,
            bound=_bound(nbytes, flops))
    return rows, c


def lm_kernel_phase(torch, ref, fa, flush, dev="cuda"):
    """The flash forward and backward kernels against their plain versions
    at the LM training shapes (B 4, S 1024, 32/8 heads, D 64; the rows),
    in fp32 at a smaller shape, at G = 3 over a ragged S, and at head dim
    128: an LM-like shape (B 2, S 1024, 20 heads over 20, qwen1.5-4b's
    G = 1) in bf16 and fp16, G = 8 (64 heads over 8) in both, and fp32;
    the D-128 times printed beside the D-64 ones."""
    B, S, H, KV, D = LM_BATCH, LM_SEQ, 32, 8, 64
    d64, _ = _lm_flash(torch, ref, fa, flush, (B, S, H, KV, D), 11, dev)
    d128, c128 = _lm_flash(torch, ref, fa, flush, (2, S, 20, 20, 128), 21,
                           dev)
    for i, (dtype, shape) in enumerate((
            (torch.float32, (1, 256, 8, 2, D)),
            (torch.bfloat16, (2, S - 24, 12, 4, D)),       # G = 3, ragged
            (torch.float16, (2, S, 20, 20, 128)),
            (torch.bfloat16, (1, S, 64, 8, 128)),
            (torch.float16, (1, S, 64, 8, 128)),
            (torch.float32, (1, 256, 8, 2, 128)))):
        fp32 = dtype == torch.float32
        _check_bwd(torch, ref, fa, dtype, shape,
                   BWD_TOL_FP32 if fp32 else BWD_TOL,
                   fwd_tol=1e-5 if fp32 else FWD_TOL, seed=12 + i, dev=dev)
    order = _bwd_grid_order(B, S, H, KV)
    print(f"flash backward grid at the LM shape: {len(order['dkv']) * KV * B} "
          f"dk/dv and {len(order['dq']) * KV * B} dq blocks, launched in rounds "
          f"of {KV * B} (kv head, batch) pairs; live tiles a block, round by "
          f"round: " + json.dumps(order))
    print("flash forward at the LM training shapes: " + json.dumps(d64["fwd"]))
    rows = [d64["flash_attention_dq"], d64["flash_attention_dkv"]]
    print("flash backward at B 4, S 1024, 32/8 heads, D 64, bf16: " +
          json.dumps({r["name"]: {k_: r[k_] for k_ in (
              "err", "rel_err", "ms", "plain_ms", "library_ms", "bound")}
              for r in rows}))
    beside = {n: dict({k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                            "bound", "bound_ms") if k_ in r},
                      ms_d64=d64[n]["ms"]) for n, r in d128.items()}
    print("flash kernels at D 128 (B 2, S 1024, 20/20 heads), bf16, beside "
          "D 64 (B 4, S 1024, 32/8 heads): " + json.dumps(dict(
              beside, errs=c128["errs"])))
    return rows


def _leaf_names(tree, prefix=""):
    """Dotted leaf paths in the port's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def lm_grad_check(torch, cfg, models, dev, shape=(2, 512), image_tokens=0,
                  fp32_plain=False):
    """decoder_loss of full ``cfg`` on ``shape`` (B x S) tokens (after
    ``image_tokens`` seeded random image embeddings a sequence; an
    encoder-decoder's loss on ``encoder_seq_len`` seeded normal frames
    before them), and the gradient of every leaf, through the kernels and
    through the einsum attention. With ``fp32_plain``, also the einsum
    route in fp32: the kernels in fp32 held to it at GRAD_TOL_FP32 and in
    bf16 at GRAD_TOL, every leaf printed. Returns the kernels' launches."""
    import numpy as np

    from repro_torch.configs.base import with_attn_impl
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch import kernels as K
    from repro_torch.tree import flatten, unflatten
    B, S = shape
    src = LMTokenSource(cfg.vocab_size, S)
    batch = {n: torch.from_numpy(v).to(dev)
             for n, v in src.batch(B, 4242).items()}
    if image_tokens:
        batch["image_embeds"] = torch.randn(
            B, image_tokens, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(5))
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            B, cfg.encoder_seq_len, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(6))
    master = models.build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(3))
    leaves, treedef = flatten(master)
    names = _leaf_names(master)
    out = {}
    c32 = cfg.with_overrides(dtype="float32")
    runs = {"flash": with_attn_impl(cfg, "flash"),
            "ref": with_attn_impl(cfg, "ref"), "fp32": c32}
    if fp32_plain:
        runs["ref_fp32"] = with_attn_impl(c32, "ref")
    for impl, c in runs.items():
        model = models.build_model(c, dev)
        ps = [t.detach().requires_grad_(True) for t in leaves]
        K.reset_launches()
        loss, _ = model.loss_fn(unflatten(treedef, ps), batch)
        grads = torch.autograd.grad(loss, ps)
        _sync(torch, dev)
        out[impl] = (loss.item(), grads, dict(K.LAUNCHES))
        del ps, loss
    L = cfg.num_layers
    fwd, dq, dkv = (MLA_KERNELS[:3] if cfg.attention.kv_lora_rank else (
        "flash_attention", "flash_attention_dq", "flash_attention_dkv"))
    want_launches = {fwd: (2 if cfg.remat else 1) * L, dq: L, dkv: L}
    if cfg.attention.kv_lora_rank and cfg.dtype != "float32":
        want_launches[MLA_KERNELS[3]] = L   # the tensor-core dk/dv's sum
    if dev.type == "cuda" and out["flash"][2] != want_launches:
        _fail(f"grad check launches {out['flash'][2]} != {want_launches}")
    def rel(a_impl, b_impl):
        return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(
            1e-30)).item() for a, b in zip(out[a_impl][1], out[b_impl][1])]

    errs = rel("flash", "ref")
    worst = sorted(zip(errs, names), reverse=True)[:4]
    d_loss = abs(out["flash"][0] - out["ref"][0])
    prefix = (f" after {image_tokens} image embeddings" if image_tokens else
              f" after {cfg.num_meta_tokens} meta tokens"
              if cfg.num_meta_tokens else
              f" against {cfg.encoder_seq_len} frames through "
              f"{cfg.num_encoder_layers} encoder layers"
              if cfg.family == "encdec" else "")
    print(f"grad check, {cfg.name} ({L} layers) on {B} x {S} tokens{prefix}, "
          f"kernels vs einsum (launches {out['flash'][2]}): "
          f"loss {out['flash'][0]:.6f} vs {out['ref'][0]:.6f} (|d| "
          f"{d_loss:.3g}); leaf gradients, relative Frobenius error: max "
          f"{max(errs):.4g}, median {float(np.median(errs)):.4g}, worst "
          f"leaves {[(n, round(e, 5)) for e, n in worst]}")
    for impl in ("flash", "ref"):
        e32 = rel(impl, "fp32")
        print(f"  {impl} (bf16) vs the kernels in fp32: loss |d| "
              f"{abs(out[impl][0] - out['fp32'][0]):.3g}; leaf gradients max "
              f"{max(e32):.4g}, median {float(np.median(e32)):.4g}")
    if not (math.isfinite(d_loss) and d_loss <= GRAD_LOSS_TOL):
        _fail(f"grad check: losses differ by {d_loss} > {GRAD_LOSS_TOL}")
    tols = [MOE_GRAD_TOL if re.search(r"\.moe\.(router|w[iud])$", n) else
            GRAD_TOL for n in names]
    bad = [(n, e, t) for n, e, t in zip(names, errs, tols)
           if not (math.isfinite(e) and e <= t)]
    if fp32_plain:
        e16, e32 = rel("flash", "ref_fp32"), rel("fp32", "ref_fp32")
        print(f"  every leaf, relative Frobenius error against the einsum "
              f"route in fp32 (loss {out['ref_fp32'][0]:.6f}), [kernels "
              f"bf16, kernels fp32]: " + json.dumps(
                  {n: [a, b] for n, a, b in zip(names, e16, e32)}))
        bad += [(n + " (bf16 vs plain fp32)", e, GRAD_TOL)
                for n, e in zip(names, e16)
                if not (math.isfinite(e) and e <= GRAD_TOL)]
        bad += [(n + " (fp32 vs plain fp32)", e, GRAD_TOL_FP32)
                for n, e in zip(names, e32)
                if not (math.isfinite(e) and e <= GRAD_TOL_FP32)]
    if bad:
        _fail(f"grad check: leaf gradients past their bound: {bad}")
    return out["flash"][2]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _phase4_requests(cfg, serve):
    """Phase 4's traffic: 16 prompts of 32-512 tokens (two share a
    256-token prefix), half greedy, half at temperature 0.8."""
    rng = __import__("numpy").random.RandomState(0)
    lens = rng.randint(32, 513, size=16)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    shared = rng.randint(0, cfg.vocab_size, size=256).tolist()
    # requests 1 and 9 share a 256-token prefix; 9 is admitted after 1 has
    # published its pages, so its prefill starts from the prefix cache
    prompts[1] = shared + prompts[1][:64]
    prompts[9] = shared + prompts[9][:96]
    SP = serve.SamplingParams
    sps = [SP(temperature=0.0) if i % 2 == 0 else SP(temperature=0.8, seed=i)
           for i in range(16)]
    return prompts, sps


def engine_phase(torch, K, cfg, models, serve, dev, logit_tol=LOGIT_TOL):
    """``cfg`` through the Engine on ``dev``; returns (launches, stats)."""
    model = models.build_model(cfg, dev)
    t0 = time.perf_counter()
    master = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    print(f"init {models.count_params(master) / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f}s")

    prompts, sps = _phase4_requests(cfg, serve)
    eng = serve.Engine(model, master, max_slots=8, max_seq=1024,
                       prefill_chunk=32, page_size=16, fused_sampling=True,
                       device=dev)
    del master
    torch.cuda.empty_cache()
    rids = [eng.submit(p, 32, sp) for p, sp in zip(prompts, sps)]
    K.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name in ("flash_attention", "flash_decode_paged",
                 "flash_decode_combine", "slot_gather_sample"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was not launched by the paged engine run")
    for r in rids:
        out = results[int(r)]
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            _fail(f"request {int(r)} returned {len(out)} tokens: {out[:8]}")
    st = eng.stats
    al = eng.allocator
    if al.hits <= 0:
        _fail("the shared-prefix request took no prefix-cache hit")
    chunks = launches["flash_attention"] // cfg.num_layers
    stats = dict(
        requests=len(rids), wall_s=wall, prefill_tokens=st.prefill_tokens,
        prefill_tok_s=st.prefill_tok_s(), decode_steps=st.steps,
        decoded_tokens=st.decoded_tokens, decode_tok_s=st.decode_tok_s(),
        prefill_chunks=chunks, prefix_hit_pages=al.hits,
        cow_copies=al.cow_copies,
        launches_per_decode_step=launches["flash_decode_paged"] / st.steps,
        launches_per_prefill_chunk=launches["flash_attention"] / chunks,
        token_latency_ms={str(q): v * 1e3 for q, v in
                          st.token_latency_percentiles().items()})
    print(f"engine {cfg.name} " + json.dumps(stats))
    print(f"decode step ({cfg.name}, 8 slots, pages of 16): "
          + json.dumps(_decode_step_cost(torch, model, eng.params, dev)))

    # contiguous pool: the path that reaches flash_decode
    eng0 = serve.Engine(model, eng.params, max_slots=4, max_seq=256,
                        prefill_chunk=32, page_size=0, fused_sampling=True,
                        device=dev)
    rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
    K.reset_launches()
    res0 = eng0.run()
    _sync(torch, dev)
    launches["flash_decode"] = K.LAUNCHES.get("flash_decode", 0)
    launches["flash_decode_combine"] += K.LAUNCHES.get("flash_decode_combine",
                                                       0)
    if launches["flash_decode"] <= 0:
        _fail("flash_decode was not launched by the contiguous engine run")
    if any(len(res0[int(r)]) != 8 for r in rids0):
        _fail("contiguous engine run did not finish its requests")
    print(f"contiguous engine launches ({cfg.name}) "
          + json.dumps(dict(K.LAUNCHES)))

    check_flash_vs_ref(torch, cfg, models, eng.params,
                       [p[:64] for p in prompts if len(p) >= 64][:3], dev,
                       logit_tol)
    return launches, stats


def _map_in_place(tree, fn):
    """Replaces each leaf of a tree of dicts and lists by ``fn(leaf)``, one
    leaf at a time."""
    for key, v in list(tree.items() if isinstance(tree, dict)
                       else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _map_in_place(v, fn)
        else:
            tree[key] = fn(v)


def _float_in_place(torch, tree, dev):
    """Casts a tree's leaves to fp32 on ``dev`` in place: every leaf to the
    host first, then each back in fp32, so the card never holds the served
    dtype's blocks beside the fp32 ones (casting leaf by leaf on the card
    left 12 GB of freed bf16 blocks that no fp32 leaf fit)."""
    _map_in_place(tree, lambda t: t.cpu())
    if str(dev) != "cpu":
        torch.cuda.empty_cache()
    _map_in_place(tree, lambda t: t.to(dev).float())


def check_flash_vs_ref(torch, cfg, models, params, prompts, dev,
                       logit_tol=None, chunk=32, consume=False):
    """Teacher-forced prefill (chunks of ``chunk``) + 4 decode steps of
    each prompt on a paged pool (pages of 16, SSM lanes one a slot),
    through the kernels and through a plain route, each in the served
    dtype and in fp32 on the same weights. The plain route is the einsum
    attention on the same pool or, with no attention, the decoder's
    forward over the whole teacher-forced sequence. Held: the kernels vs
    the plain route in fp32 at FP32_LOGIT_TOL of the largest logit (only
    the order of sums differs there, so a kernel or carry fault shows far
    above rounding), and in the served dtype at ``logit_tol`` or, where it
    is None, at twice the plain route's own distance from its fp32 run
    (the control: two paths each that far from fp32 lie at most twice
    that far apart). With ``consume`` the fp32 runs take ``params`` cast
    to fp32 in place after the served dtype's runs (a model whose weights
    fit the card in bf16 but not in both dtypes); the caller holds no
    other reference to its leaves."""
    from repro_torch.configs.base import with_attn_impl
    from repro_torch.tree import flatten, unflatten

    def fp32_params():
        if consume:
            _float_in_place(torch, params, dev)
            return params
        leaves, treedef = flatten(params)
        return unflatten(treedef, [t.float() for t in leaves])
    c32 = cfg.with_overrides(dtype="float32")
    attn = cfg.attention is not None
    runs = {"kernels": (with_attn_impl(cfg, "flash"), params),
            "plain": (with_attn_impl(cfg, "ref"), params),
            "kernels_fp32": (c32, None),
            "plain_fp32": (with_attn_impl(c32, "ref"), None)}
    outs = {impl: [] for impl in runs}
    p32 = None
    for impl, (c, ps) in runs.items():
        if ps is None:
            if p32 is None:
                p32 = fp32_params()
            ps = p32
        m = models.build_model(c, dev)
        for prompt in prompts:
            n = len(prompt)
            toks = torch.tensor(prompt + prompt[:4], dtype=torch.int64,
                                device=dev)
            sizes = [min(chunk, n - ch) for ch in range(0, n, chunk)]
            if impl.startswith("plain") and not attn:
                lg = m.forward(ps, {"tokens": toks[None]})[0].float()
                outs[impl] += list(lg.split(sizes + [1] * 4))
                continue
            S = -(-(n + 4) // 128) * 128          # lanes of 128 positions
            pool = m.init_paged_cache(1, 16, S // 16 + 1)
            kw = dict(seq_len=S, page_size=16, block_tables=torch.arange(
                1, S // 16 + 1, dtype=torch.int32, device=dev)[None])
            for ch, c_ in zip(range(0, n, chunk), sizes):
                lg, pool = m.chunk_prefill(ps, pool, toks[None, ch:ch + c_],
                                           ch, c_, **kw)
                outs[impl].append(lg.float().reshape(c_, -1))
            for i in range(4):
                lg, pool = m.decode_step(ps, pool,
                                         {"tokens": toks[None, n + i:n + i + 1]},
                                         torch.tensor([n + i], device=dev),
                                         **kw)
                outs[impl].append(lg.float().reshape(1, -1))
            del pool
    del runs, p32
    err = lambda a, b: [(x - y).abs().max().item()  # noqa: E731
                        for x, y in zip(outs[a], outs[b])]
    errs, errs32 = err("kernels", "plain"), err("kernels_fp32", "plain_fp32")
    scale = max(b.abs().max().item() for b in outs["plain_fp32"])
    control = max(err("plain", "plain_fp32"))
    limit = 2 * control if logit_tol is None else logit_tol
    top1 = sum(int((a.argmax(-1) == b.argmax(-1)).all())
               for a, b in zip(outs["kernels"], outs["plain"]))
    route = "einsum attention" if attn else "the whole-sequence forward"
    print(f"teacher-forced logits ({cfg.name}, prompts of "
          f"{[len(p) for p in prompts]} tokens in chunks of {chunk} + 4 "
          f"decode steps), kernels vs {route}: {cfg.dtype} max err per call "
          f"{errs} (limit {limit:.4g}), calls with equal top-1 "
          f"{top1}/{len(errs)}; fp32 max err {max(errs32):.4g} of max "
          f"|logit| {scale:.3f} (limit {FP32_LOGIT_TOL * scale:.4g}); "
          f"distance from fp32, kernels {max(err('kernels', 'kernels_fp32')):.4g}"
          f", plain (the control) {control:.4g}")
    if not all(math.isfinite(e) for e in errs + errs32) or (
            max(errs32) > FP32_LOGIT_TOL * scale):
        _fail(f"{cfg.name}: kernels vs {route} logits in fp32 differ by "
              f"{max(errs32)} > {FP32_LOGIT_TOL} of {scale}")
    if max(errs) > limit:
        _fail(f"{cfg.name}: kernels vs {route} logits differ by {max(errs)} "
              f"> {limit}")


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

F6_BUCKET = 9216 * 4096            # full AlexNet's f6.w bucket
F6_SHARD = F6_BUCKET // 2          # its shard at k=2


def train_kernel_phase(torch, ref, flush):
    """Each training kernel against its plain version at full-width
    AlexNet shapes (the f6.w bucket and its k=2 shard)."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import quantize as qz
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4321)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    n, s, k = F6_BUCKET, F6_SHARD, 2
    rows = []

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    def row(name, src, replaces, got, want, ms, plain_ms, library_ms, bound,
            host_ms):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            _fail(f"{name} differs from its plain version")
        fin = [(a[torch.isfinite(a)].float(), b[torch.isfinite(b)].float())
               for a, b in zip(got, want)]
        err = max((a - b).abs().max().item() for a, b in fin)
        if not err <= UPDATE_TOL:
            _fail(f"{name} vs plain: max err {err} > {UPDATE_TOL}")
        rows.append(dict(name=name, src=f"src/repro_torch/csrc/{src}",
                         replaces=replaces, err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound=bound, host_ms=host_ms))

    # --- chunk_sum: the (2, s) fp16 receive of the f6.w shard
    recv = rn(k, s).half()
    row("chunk_sum", "exchange.cu", "src/repro/kernels/chunk_sum.py:29",
        cs.chunk_sum(recv), ref.chunk_sum_ref(recv),
        _median_ms(lambda: cs.chunk_sum(recv), flush=flush),
        _median_ms(lambda: ref.chunk_sum_ref(recv), flush=flush),
        _median_ms(lambda: torch.sum(recv, 0, dtype=torch.float32),
                   flush=flush),
        _bound(recv.numel() * 2 + s * 4, (k - 1) * s, FP32_FLOP_S),
        _host_ms(lambda: cs.chunk_sum(recv)))

    # --- the fp16 wire casts of the whole f6.w bucket (about 0.1 % of
    # the values lie past fp16's range, so overflow to inf is exercised)
    x = rn(n) * 20000
    h = x.half()
    row("quant_fp16", "exchange.cu", "src/repro/kernels/quantize.py:39",
        qz.quant_fp16(x), ref.quant_fp16_ref(x),
        _median_ms(lambda: qz.quant_fp16(x), flush=flush),
        _median_ms(lambda: ref.quant_fp16_ref(x), flush=flush),
        _median_ms(lambda: x.half(), flush=flush),
        _bound(n * 4 + n * 2, n, FP32_FLOP_S),
        _host_ms(lambda: qz.quant_fp16(x)))
    row("dequant_fp16", "exchange.cu", "src/repro/kernels/quantize.py:57",
        qz.dequant_fp16(h), ref.dequant_fp16_ref(h),
        _median_ms(lambda: qz.dequant_fp16(h), flush=flush),
        _median_ms(lambda: ref.dequant_fp16_ref(h), flush=flush),
        _median_ms(lambda: h.float(), flush=flush),
        _bound(n * 2 + n * 4, n, FP32_FLOP_S),
        _host_ms(lambda: qz.dequant_fp16(h)))

    # --- fused_sgd over the whole f6.w bucket
    p, gr, m = rn(n) * 0.01, rn(n) * 0.001, rn(n) * 0.001
    lr = torch.tensor([0.01], device=dev)
    sgd_p = p.clone().requires_grad_(True)
    sgd_p.grad = gr.clone()
    sgd = torch.optim.SGD([sgd_p], lr=0.01, momentum=0.9, fused=True)
    # the yardstick: PyTorch's fused SGD on the same bytes (launched from
    # the host; its first step allocates the momentum buffer)
    row("fused_sgd", "sgd.cu", "src/repro/kernels/fused_sgd.py:24",
        fs.fused_sgd(p, gr, m, lr, 0.9), ref.fused_sgd_ref(p, gr, m, lr, 0.9),
        _median_ms(lambda: fs.fused_sgd(p, gr, m, lr, 0.9), flush=flush),
        _median_ms(lambda: ref.fused_sgd_ref(p, gr, m, lr, 0.9),
                   flush=flush),
        _event_ms(sgd.step),
        _bound(5 * n * 4, 5 * n, FP32_FLOP_S),
        _host_ms(lambda: fs.fused_sgd(p, gr, m, lr, 0.9)))
    del sgd, sgd_p

    # --- fused_rs_update on the f6.w shard: fp16 receive, and int8 with
    # one scale per received chunk (its numbers are printed on their own)
    ps, ms_, mask = rn(s) * 0.01, rn(s) * 0.001, torch.ones(s, device=dev)
    args = dict(wd_mask=mask, scale=1 / k, momentum=0.9, weight_decay=5e-4)
    fused = lambda r, sc=None: fru.fused_rs_update(r, ps, ms_, lr, **args,
                                                   scales=sc)
    plain = lambda r, sc=None: ref.fused_rs_update_ref(
        r, ps, ms_, mask, lr, 0.9, False, 1 / k, 5e-4, sc)
    row("fused_rs_update", "sgd.cu",
        "src/repro/kernels/fused_rs_update.py:53",
        fused(recv), plain(recv),
        _median_ms(lambda: fused(recv), flush=flush),
        _median_ms(lambda: plain(recv), flush=flush), None,
        _bound(recv.numel() * 2 + 5 * s * 4, (k + 7) * s, FP32_FLOP_S),
        _host_ms(lambda: fused(recv)))
    q = torch.randint(-127, 128, (k, s), generator=g, device=dev).to(
        torch.int8)
    sc = torch.rand(k, generator=g, device=dev) * 1e-3
    got_q, want_q = fused(q, sc), plain(q, sc)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got_q, want_q)):
        _fail("fused_rs_update (int8 wire) differs from its plain version")
    err_q = max((a - b).abs().max().item() for a, b in zip(got_q, want_q))
    b_q = _bound(q.numel() + k * 4 + 5 * s * 4, (2 * k + 7) * s, FP32_FLOP_S)
    print("fused_rs_update int8 wire (_kernel_q, fused_rs_update.py:60), "
          "(2, 18874368) + (2,) scales: " +
          json.dumps({"max_abs_err": err_q,
                      "ms": _median_ms(lambda: fused(q, sc), flush=flush),
                      "plain_ms": _median_ms(lambda: plain(q, sc),
                                             flush=flush),
                      "bound_ms": b_q[0], "bound_by": b_q[1]}))
    del q, sc, got_q, want_q, ps, ms_, mask, p, gr, m, recv
    int8_launches = int8_kernel_rows(torch, ref, qz, flush, row)
    return rows, int8_launches


INT8_ODD = 2048 * 1000 + 777       # a length that is not a multiple of 2048


def int8_kernel_rows(torch, ref, qz, flush, row, dev="cuda"):
    """The blockwise int8 quantizers: a round trip through the wrappers on
    the f6.w bucket (the counts zeroed just before and read just after:
    the path's launches), then each kernel held bit for bit to its plain
    version at that length and at INT8_ODD, and timed at the first. The
    rows go through ``row``; returns the round trip's launches. The input,
    ties and an all-zero block included, is the CPU tests' own."""
    from test_torch_ranks import int8_input

    from repro_torch import kernels as K
    n = F6_BUCKET
    x, pos = int8_input(n, dev)
    K.reset_launches()
    q, sc = qz.quant_int8(x)
    back = qz.dequant_int8(q, sc)
    _sync(torch, x.device)
    launches = dict(K.LAUNCHES)
    if launches != {"quant_int8": 1, "dequant_int8": 1}:
        _fail(f"int8 round trip launched {launches}")
    step = sc.repeat_interleave(2048)[:n]
    if not bool(((back - x).abs() <= 0.5 * step + 2.0 ** -22 * x.abs())
                .all()):
        _fail("int8 round trip lands further than half a step")
    if pos.numel() < 40 or bool((q[pos].int() % 2).any()):
        _fail(f"{pos.numel()} ties, rounded to {q[pos].tolist()[:8]}...")
    print(f"int8 round trip of {n} values: {pos.numel()} ties rounded to "
          f"even, max |x - dq(q(x))| / scale "
          f"{((back - x).abs() / step).max().item():.6f}")
    if sc[1].item() != ref.quant_int8_ref(torch.zeros(1, device=x.device))[
            1].item() or bool(q[2048:4096].any()):
        _fail("the all-zero block does not quantize to 0 with scale 1e-12")
    for n_, xx in ((INT8_ODD, int8_input(INT8_ODD, dev)[0]),
                   (n, x)):
        qq, ss = ref.quant_int8_ref(xx)
        got = qz.quant_int8(xx)
        if not (torch.equal(got[0], qq) and torch.equal(
                got[1].view(torch.int32), ss.view(torch.int32))):
            _fail(f"quant_int8 differs from its plain version at n={n_}")
        if not torch.equal(qz.dequant_int8(qq, ss).view(torch.int32),
                           ref.dequant_int8_ref(qq, ss).view(torch.int32)):
            _fail(f"dequant_int8 differs from its plain version at n={n_}")
    nb = sc.numel()
    qr, sr = ref.quant_int8_ref(x)
    # no single PyTorch call computes blockwise-absmax int8: library_ms None
    row("quant_int8", "exchange.cu", "src/repro/kernels/quantize.py:80",
        (q.view(torch.int8).float(), sc), (qr.float(), sr),
        _median_ms(lambda: qz.quant_int8(x), flush=flush),
        _median_ms(lambda: ref.quant_int8_ref(x), flush=flush), None,
        _bound(4 * n + n + 4 * nb, 5 * n, FP32_FLOP_S),
        _host_ms(lambda: qz.quant_int8(x)))
    row("dequant_int8", "exchange.cu", "src/repro/kernels/quantize.py:106",
        qz.dequant_int8(q, sc), ref.dequant_int8_ref(q, sc),
        _median_ms(lambda: qz.dequant_int8(q, sc), flush=flush),
        _median_ms(lambda: ref.dequant_int8_ref(q, sc), flush=flush), None,
        _bound(n + 4 * nb + 4 * n, n, FP32_FLOP_S),
        _host_ms(lambda: qz.dequant_int8(q, sc)))
    return launches


def wire_check(torch, ref, shapes, label, weight_decay, dev="cuda",
               overlap_m: int = 0, k: int = 2):
    """The wire, sum and update kernels at every bucket shape of a training
    run on ``k`` ranks, bit for bit against their plain versions: per
    (padded, shard) bucket, quant_fp16 of the (k, shard) chunks, of the
    first shard and of the last (a row that starts shard values into the
    bucket, as a ring hop sends it), chunk_sum of the (k, shard) fp16
    receive, dequant_fp16 of the gathered (padded,) bucket and of a
    received (shard,) row at either end, and fused_rs_update of the
    (k, shard) fp16 receive (with the run's momentum and weight decay over
    a mixed 0/1 decay mask). The values reach past fp16's range, so
    overflow to inf (and inf - inf = NaN in the sum, which must be NaN in
    both) is exercised. With ``overlap_m`` > 0 also dequant_fp16 of the
    (k, shard) receive and fused_rs_update of an fp32 (k, shard) receive at
    scale 1 / (k m): the overlap's accumulated chunks."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import quantize as qz
    g = torch.Generator(device=dev).manual_seed(4322)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    lr = torch.tensor([0.01], device=dev)
    bits = lambda t: t.view({2: torch.int16, 4: torch.int32}[
        t.element_size()])
    same = lambda a, b: torch.equal(bits(a), bits(b))

    def same_or_nan(a, b):
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(
            bits(a)[~nan], bits(b)[~nan])
    for padded, s in shapes:
        if padded != k * s:
            _fail(f"{label} bucket {padded} is not {k} shards of {s}")
        x = rn(k, s) * 20000
        recv = x.half()
        ps, ms_ = rn(s) * 0.01, rn(s) * 0.001
        mask = (torch.rand(s, generator=g, device=dev) < 0.9).float()
        got = fru.fused_rs_update(recv, ps, ms_, lr, wd_mask=mask,
                                  scale=1 / k, momentum=0.9,
                                  weight_decay=weight_decay)
        want = ref.fused_rs_update_ref(recv, ps, ms_, mask, lr, 0.9, False,
                                       1 / k, weight_decay, None)
        ok = {"quant_fp16 (k, shard)": same(qz.quant_fp16(x),
                                            ref.quant_fp16_ref(x)),
              "chunk_sum (k, shard)": same_or_nan(cs.chunk_sum(recv),
                                                  ref.chunk_sum_ref(recv))}
        for r in (0, k - 1):
            ok[f"quant_fp16 shard {r}"] = same(qz.quant_fp16(x[r]),
                                               ref.quant_fp16_ref(x[r]))
            ok[f"dequant_fp16 shard {r}"] = same(
                qz.dequant_fp16(recv[r]), ref.dequant_fp16_ref(recv[r]))
        ok["dequant_fp16 (padded,)"] = same(
            qz.dequant_fp16(recv.reshape(-1)),
            ref.dequant_fp16_ref(recv.reshape(-1)))
        ok["fused_rs_update"] = all(same(a, b) for a, b in zip(got, want))
        if overlap_m:
            ok["dequant_fp16 (k, shard)"] = same(qz.dequant_fp16(recv),
                                                 ref.dequant_fp16_ref(recv))
            acc = x * 0.01
            got = fru.fused_rs_update(acc, ps, ms_, lr, wd_mask=mask,
                                      scale=1 / (k * overlap_m),
                                      momentum=0.9,
                                      weight_decay=weight_decay)
            want = ref.fused_rs_update_ref(acc, ps, ms_, mask, lr, 0.9, False,
                                           1 / (k * overlap_m), weight_decay,
                                           None)
            ok["fused_rs_update (fp32 receive)"] = all(
                same(a, b) for a, b in zip(got, want))
            del acc
        if not all(ok.values()):
            _fail(f"{label} bucket {padded} (k={k}): a wire, sum or update "
                  f"kernel differs from its plain version: {ok}")
        del x, recv, ps, ms_, mask, got, want
    print(f"{label}: the fp16 wire kernels, chunk_sum and fused_rs_update"
          f"{' (fp16 and fp32 receives)' if overlap_m else ''} equal their "
          f"plain versions bit for bit at k={k} at all {len(shapes)} bucket "
          f"shapes (padded, shard): {json.dumps(shapes)}")


def sgd_check(torch, ref, shapes, label, dev="cuda"):
    """fused_sgd bit for bit against its plain version at every leaf and
    shard shape of a training run (the unsharded update calls it on every
    leaf, the sharded one on the small leaves or the shards)."""
    from repro_torch.kernels import fused_sgd as fs
    g = torch.Generator(device=dev).manual_seed(4323)
    rn = lambda s: torch.randn(s, generator=g, device=dev)
    lr = torch.tensor([0.01], device=dev)
    for shape in shapes:
        p, gr, m = rn(shape) * 0.01, rn(shape) * 0.001, rn(shape) * 0.001
        got = fs.fused_sgd(p, gr, m, lr, 0.9)
        want = ref.fused_sgd_ref(p, gr, m, lr, 0.9)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            _fail(f"{label}: fused_sgd differs from its plain version at "
                  f"{tuple(shape)}")
    print(f"{label}: fused_sgd equals its plain version bit for bit at all "
          f"{len(shapes)} leaf and shard shapes")


def conv_precision(torch):
    """The weight gradient of AlexNet's c2 (5x5, 2 groups of 48 input
    channels, 27x27 maps) at batch 32 and 64 in fp32, with cuDNN and with
    PyTorch's own convolution, against fp64: max error over the largest
    magnitude. A measurement of the library, printed, not gated."""
    import torch.nn.functional as F
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 96, 27, 27, generator=g, device=dev,
                    dtype=torch.float64)
    w = torch.randn(256, 48, 5, 5, generator=g, device=dev,
                    dtype=torch.float64) * 0.05
    go = torch.randn(64, 256, 27, 27, generator=g, device=dev,
                     dtype=torch.float64)

    def wgrad(b, dtype):
        wd = w.to(dtype).requires_grad_(True)
        y = F.conv2d(x[:b].to(dtype), wd, padding=2, groups=2)
        return torch.autograd.grad(y, wd, go[:b].to(dtype))[0].double()

    out = {}
    for b in (32, 64):
        ref = wgrad(b, torch.float64)
        for name, on in (("cudnn", True), ("native", False)):
            with torch.backends.cudnn.flags(enabled=on):
                err = (wgrad(b, torch.float32) - ref).abs().max()
            out[f"{name}_b{b}"] = (err / ref.abs().max()).item()
    print("c2 weight gradient, fp32 vs fp64, max error / max |g|: "
          + json.dumps(out))


def _predicted_launches(rsplan, n_leaves: int, ex: str, sharded: bool,
                        steps: int, fused: bool, k: int = 2):
    """Kernel launches of one rank over ``steps`` steps of a run, from its
    bucket plan: nb buckets (reduce-scattered, each shard updated and
    all-gathered) and ns small leaves (all-reduced, flat-updated).
    ``fused``: the sharded runs take the fused_rs_update kernel (the
    default where the parameters are on the card)."""
    nb, ns = rsplan.num_buckets, len(rsplan.small)
    ex = {"hier16": "asa16", "hier": "asa"}.get(ex, ex)   # the pod's wire
    asa16 = ex == "asa16"
    if ex == "ring16":   # k - 1 hops of each half, fp16 out and in per hop
        hops = 2 * (k - 1) * nb
        per_step = {"quant_fp16": hops, "dequant_fp16": hops}
        per_step["fused_sgd"] = ns + nb if sharded else n_leaves
    elif not sharded and ex == "asa":   # fp32: the sum alone
        per_step = {"chunk_sum": nb, "fused_sgd": n_leaves}
    elif not sharded:    # asa16: fp16 RS out, the sum, fp16 AG
        per_step = {"quant_fp16": 2 * nb, "dequant_fp16": nb,  # out and in,
                    "chunk_sum": nb, "fused_sgd": n_leaves}   # every leaf
    elif fused:          # sharded: fused tail, fp16 parameter AG
        per_step = {"fused_rs_update": nb, "fused_sgd": ns,
                    "quant_fp16": nb * (2 if asa16 else 1),
                    "dequant_fp16": nb}
    else:                # sharded, unfused: sum (fp16 wire) + flat update
        per_step = {"fused_sgd": nb + ns, "dequant_fp16": nb,
                    "quant_fp16": nb * (2 if asa16 else 1)}
        if asa16:
            per_step["chunk_sum"] = nb
    return {name: c * steps for name, c in per_step.items() if c}


HALF_TIMING_CAP = 256 << 20   # the train loop's cap on timing the halves


def _halves_launches(rsplan, ex: str, grad_bytes: int, k: int = 2) -> dict:
    """Kernel launches of the exchange halves that a profiled run (the
    launcher's default) counts after its first step
    (``train.loop._profile_exchange_halves``): the reduce-scatter half and
    the parameter all-gather half alone on zero gradients of
    ``grad_bytes``, once each, and twice more when they take at most
    HALF_TIMING_CAP bytes. The all-gather goes at ``param_wire_dtype``'s
    width."""
    nb = rsplan.num_buckets
    ex = {"hier16": "asa16", "hier": "asa"}.get(ex, ex)   # the pod's wire
    if ex == "ring16":       # k - 1 hops of each half, fp16 out and in
        hops = 2 * (k - 1) * nb
        per = {"quant_fp16": hops, "dequant_fp16": hops}
    elif ex == "asa16":      # fp16 RS out, the sum; fp16 AG out and in
        per = {"quant_fp16": 2 * nb, "chunk_sum": nb, "dequant_fp16": nb}
    elif ex == "asa8":       # the int8 RS in plain ops; the fp16 AG
        per = {"quant_fp16": nb, "dequant_fp16": nb}
    elif ex in ("asa", "asabf16"):   # the sum; no cast kernel
        per = {"chunk_sum": nb}
    else:                    # ar, ring: no kernel
        per = {}
    runs = 3 if grad_bytes <= HALF_TIMING_CAP else 1
    return {n: c * runs for n, c in per.items() if c}


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _plus(*counts) -> dict:
    """Launch counts added kernel by kernel."""
    out = {}
    for c in counts:
        for n, v in c.items():
            out[n] = out.get(n, 0) + v
    return {n: v for n, v in out.items() if v}


# The convnet training phases: per arch, the full config's parameter count,
# images per rank and step, the runs (name, exchanger, sharded, steps),
# and whether one asa step of k=2 on halves is held to k=1 on the whole
# batch, and to what bound.
TRAIN_ARCHS = {
    "alexnet": dict(params=60_965_224, batch=128,
                    runs=(("a", "asa16", True, 4), ("b", "asa16", False, 4),
                          ("c", "asa8", True, 4)), k_tol=K_TOL),
    "googlenet": dict(params=GOOGLENET_PARAMS, batch=32,
                      runs=(("a", "asa16", True, 3),
                            ("b", "ring16", False, 2)), k_tol=K_TOL_GOOGLENET),
    "vggnet": dict(params=138_357_544, batch=16,
                   runs=(("a", "asa16", True, 2),), k_tol=None),
}


def _train_rank(rank, k, out_dir, device, smoke, arch="alexnet"):
    """One rank of a convnet training phase (a spawned process on
    ``device``: cuda:0, or the CPU with the smoke config to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    spec = TRAIN_ARCHS[arch]
    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    n_params = count_params(shapes)
    if not smoke and n_params != spec["params"]:
        _fail(f"{arch} has {n_params} parameters, not {spec['params']:,}")
    batch = 4 if smoke else spec["batch"]
    rsplan = exchanger.make_rs_plan(shapes, k)
    n_leaves = len(leaves(shapes))
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"data{rank}"))
    out = {"runs": {}, "rank": rank, "params": n_params,
           "buckets": rsplan.num_buckets, "small_leaves": len(rsplan.small),
           "bucket_shapes": sorted({(b.padded, b.shard_len)
                                    for b in rsplan.buckets}),
           "leaf_shapes": sorted({tuple(t.shape) for t in leaves(shapes)})}
    for run, ex, sharded, steps in spec["runs"]:
        opt, lr = recipe(cfg, steps)
        loader = rank_loader(cfg, files, dev, steps, seed=rank)
        plan = TrainPlan(exchanger=ex, sharded_update=sharded)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        _, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=steps, log_every=steps,
                       seed=0, print_fn=lambda *a: None)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        out["runs"][run] = dict(
            exchanger=ex, sharded=sharded, steps=rep.steps, want_steps=steps,
            losses=rep.losses, images_per_s=rep.steady_examples_per_s,
            first_step_s=rep.first_step_time,
            phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
            staged_mb_per_step=rep.staged_bytes / 1e6,
            stage_ms_per_step=rep.stage_s * 1e3,
            wire_ms_per_step=rep.wire_s * 1e3,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                         else None),
            launches=launches,
            predicted=_plus(
                _predicted_launches(rsplan, n_leaves, ex, sharded, steps,
                                    cuda, k),
                _halves_launches(rsplan, ex, _tree_bytes(shapes), k)))
        del rep
        if cuda:
            torch.cuda.empty_cache()

    if spec["k_tol"] is not None:
        # one asa step: the two ranks on two halves of a batch, then a
        # group of one (rank 0) on the whole batch, from the same parameters
        solo = dist.new_group([0])
        src = ImageSource(cfg.image_size, cfg.num_classes)
        full = {n_: torch.from_numpy(v).to(dev)
                for n_, v in src.batch(2 * batch // 4, 12345).items()}
        half = {n_: v[rank * batch // 4:(rank + 1) * batch // 4]
                for n_, v in full.items()}
        params = model.init(torch.Generator(device=dev).manual_seed(7))
        asa = exchanger.get_exchanger("asa")
        state = {"params": params, "opt": opt.init(params), "step": 0}
        names = _leaf_names(params)
        # cuDNN off: its fp32 weight-gradient path for AlexNet's c2 (5x5, 48
        # input channels a group) errs by ~1 % of the gradient's scale,
        # differently at batch 32 and 64 (see the c2 line), which would
        # swamp the exchange's own agreement that this check is about
        with torch.backends.cudnn.flags(enabled=False):
            two, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01))(
                state, half)
            if rank == 0:
                one, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01),
                                           group=solo)(state, full)
        if rank == 0:
            per_leaf = {
                n_: {"max_abs_dp": (a - b).abs().max().item(),
                     "max_abs_step": (b - p0).abs().max().item()}
                for n_, a, b, p0 in zip(names, leaves(two["params"]),
                                        leaves(one["params"]),
                                        leaves(params))}
            out["k2_vs_k1"] = per_leaf
            out["k2_vs_k1_max_abs_dp"] = max(v["max_abs_dp"]
                                             for v in per_leaf.values())
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _train_ranks(rank, k, out_dir, device, smoke, archs):
    """Every convnet of ``archs`` on this rank, one after the other in one
    process (a spawn a model cost ~10 s of start-up each); each writes
    into its own directory."""
    import os
    for arch in archs:
        sub = os.path.join(out_dir, arch)
        os.makedirs(sub, exist_ok=True)
        _train_rank(rank, k, sub, device, smoke, arch)


def train_phase(device="cuda:0", smoke=False, archs=tuple(TRAIN_ARCHS)):
    """Spawns the k=2 rank processes once for every convnet of ``archs``
    and checks what they report; returns, per arch, rank 0's launches
    summed over its runs, and its (padded, shard) bucket shapes with the
    leaf and shard shapes that fused_sgd updates."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_train_ranks, k, (td, device, smoke, tuple(archs)),
                  backend="gloo")
        wall = time.perf_counter() - t0
        reports = {arch: [json.loads(Path(td, arch, f"rank{r}.json")
                                     .read_text()) for r in range(k)]
                   for arch in archs}
    print(f"convnet train phase ({', '.join(archs)}): {k} gloo ranks on "
          f"{device}, {wall:.1f}s")
    return {arch: _check_train(arch, ranks) for arch, ranks in
            reports.items()}


def _check_train(arch, ranks):
    """One convnet's checks and prints (see :func:`train_phase`)."""
    spec = TRAIN_ARCHS[arch]
    r0 = ranks[0]
    print(f"{arch}: {r0['params']:,} parameters in {r0['buckets']} buckets "
          f"and {r0['small_leaves']} small leaves")
    total = {}
    for run, ex, sharded, steps in spec["runs"]:
        for rk in ranks:
            rr = rk["runs"][run]
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != steps or bad:
                _fail(f"{arch} run {run} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if rr["launches"] != rr["predicted"]:
                _fail(f"{arch} run {run} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")
        rr = r0["runs"][run]
        for name, c in rr["launches"].items():
            total[name] = total.get(name, 0) + c
        print(f"{arch} train run ({run}) {ex}{' sharded' if sharded else ''}"
              f", {steps} steps: " + json.dumps({key: rr[key] for key in (
                  "images_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "stage_ms_per_step",
                  "wire_ms_per_step", "launches", "predicted", "losses")}))
        print(f"{arch} run ({run}) peak memory per rank, GB: " + json.dumps(
            [rk["runs"][run]["peak_mem_gb"] for rk in ranks]))
    if spec["k_tol"] is not None:
        dp = r0["k2_vs_k1_max_abs_dp"]
        print(f"{arch} k2_vs_k1 per leaf: " + json.dumps(r0["k2_vs_k1"]))
        print(f"{arch} asa step, k=2 on halves vs k=1 on the batch: max |dp| "
              f"{dp} (bound {spec['k_tol']})")
        if not dp <= spec["k_tol"]:
            _fail(f"{arch}: k=2 and k=1 asa steps differ by {dp} > "
                  f"{spec['k_tol']}")
    buckets = [tuple(b) for b in r0["bucket_shapes"]]
    sgd_shapes = ([tuple(sh) for sh in r0["leaf_shapes"]]
                  + sorted({(sh,) for _, sh in buckets}))
    return total, (buckets, sgd_shapes)


def _lm_predicted(cfg, params, k: int, cuda: bool) -> dict:
    """One rank's launches over the LM run's LM_STEPS steps, the exchange
    halves apart: the flash forward (twice a layer under remat), dq and
    dk/dv a layer, and the asa16 sharded exchange."""
    from repro_torch.core import exchanger
    from repro_torch.tree import leaves
    L = cfg.num_layers
    return _plus(_predicted_launches(exchanger.make_rs_plan(params, k),
                                     len(leaves(params)), "asa16", True,
                                     LM_STEPS, cuda, k),
                 dict(flash_attention=(2 if cfg.remat else 1) * L * LM_STEPS,
                      flash_attention_dq=L * LM_STEPS,
                      flash_attention_dkv=L * LM_STEPS))


def _lm_attribution(torch, cfg, rep, n_params: int, batch: int,
                    seq: int) -> dict:
    """What phase 15(c) checks of a profiled LM run: the programs'
    profiles, the loop's gauges, the peaks, and the flash kernels' flops
    of one step (their cost functions at the run's shapes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline import analysis as tan
    from repro_torch.telemetry import profile
    L, H, KV, D = (cfg.num_layers, cfg.attention.num_heads,
                   cfg.attention.num_kv_heads, cfg.attention.head_dim)
    zq = torch.zeros(batch, dtype=torch.int32)
    attn = L * sum(
        fa.attention_cost(part, batch, seq, seq, H, KV, D, D, zq, 0, 2)[0]
        * times for part, times in (("fwd", 2 if cfg.remat else 1),
                                    ("dq", 1), ("dkv", 1)))
    return dict(
        n_params=n_params, tokens=batch * seq, attention_flops=attn,
        peaks=tan.peaks(), tokens_per_s=rep.steady_tokens_per_s,
        first_step_s=rep.first_step_time,
        programs={n: _profile_dict(profile.get(n)) for n in (
            "train/step", "exchange/rs", "exchange/ag")},
        step_bytes_by_op=(profile.get("train/step").meta.get("bytes_by_op")
                          if profile.get("train/step") else None),
        gauges={n: rep.metrics[n].value for n in (
            "train/model_flops_s", "train/mfu", "train/device_mem_bytes")
            if n in rep.metrics})


def _lm_rank(rank, k, out_dir, device, smoke):
    """One rank of the LM training phase (a spawned process on ``device``:
    cuda:0, or the CPU with the smoke config to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant, sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()        # the fp32 k=2 vs k=1 check wants full fp32 matmuls
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    quiet = lambda *a: None
    opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                       fused_kernel=fs.fused_sgd)
    plan = TrainPlan(exchanger="asa16", sharded_update=True)
    out = {"rank": rank}

    # --- the main path: full llama3.2-1b, asa16 with the fused RS tail,
    # per-program attribution on (the launcher's default), the card's peak
    # named for train/mfu (phase 15(c) reads the profiles)
    from repro_torch.roofline import analysis as tan
    os.environ["REPRO_PEAK_FLOPS"] = repr(tan.peaks()["flops"])
    cfg = (get_smoke_config("llama3.2-1b") if smoke else get_config(
        "llama3.2-1b").with_overrides(num_layers=LM_LAYERS))
    model = build_model(cfg, dev)
    batch, seq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    files = write_rank_batches(cfg, rank, k, batch, LM_STEPS,
                               os.path.join(out_dir, f"lm{rank}"), seq=seq)
    loader = rank_loader(cfg, files, dev, LM_STEPS, seed=rank)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = train(model, opt, warmup_cosine(0.01, 2, LM_STEPS), loader,
                       plan=plan, num_steps=LM_STEPS, log_every=LM_STEPS,
                       seed=0, print_fn=quiet)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    loader.stop()
    n_params = count_params(state["params"])
    if not smoke and n_params != LM_PARAMS:
        _fail(f"llama3.2-1b at {LM_LAYERS} layers has {n_params} "
              f"parameters, not {LM_PARAMS:,}")
    rsplan = exchanger.make_rs_plan(state["params"], k)
    predicted = _plus(_lm_predicted(cfg, state["params"], k, cuda),
                      _halves_launches(rsplan, "asa16",
                                       _tree_bytes(state["params"]), k))
    out["attribution"] = _lm_attribution(torch, cfg, rep, n_params,
                                         batch, seq)
    out["main"] = dict(
        params=n_params, steps=rep.steps, losses=rep.losses,
        tokens_per_s=rep.steady_tokens_per_s,
        first_step_s=rep.first_step_time,
        phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
        staged_mb_per_step=rep.staged_bytes / 1e6,
        stage_ms_per_step=rep.stage_s * 1e3,
        wire_ms_per_step=rep.wire_s * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        buckets=rsplan.num_buckets, launches=launches,
        bucket_shapes=sorted({(b.padded, b.shard_len)
                              for b in rsplan.buckets}),
        predicted=predicted)
    del state, model, loader
    if cuda:
        torch.cuda.empty_cache()

    # --- one fp32 asa step at the smoke config, the attention through the
    # kernels: the two ranks on two halves, then a group of one (rank 0)
    # on the whole batch, from the same parameters
    solo = dist.new_group([0])
    scfg = get_smoke_config("llama3.2-1b").with_overrides(dtype="float32")
    smodel = build_model(scfg, dev)
    full = {n: torch.from_numpy(v).to(dev) for n, v in
            LMTokenSource(scfg.vocab_size, 64).batch(4, 777).items()}
    half = {n: v[rank * 2:(rank + 1) * 2] for n, v in full.items()}
    params = smodel.init(torch.Generator(device=dev).manual_seed(7))
    sstate = {"params": params, "opt": opt.init(params), "step": 0}
    asa = exchanger.get_exchanger("asa")
    K.reset_launches()
    two, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01))(sstate, half)
    out["k2_launches"] = dict(K.LAUNCHES)
    if rank == 0:
        one, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01),
                                   group=solo)(sstate, full)
        out["k2_vs_k1_max_abs_dp"] = max(
            (a - b).abs().max().item()
            for a, b in zip(leaves(two["params"]), leaves(one["params"])))
        out["k2_vs_k1_max_abs_step"] = max(
            (b - p0).abs().max().item()
            for b, p0 in zip(leaves(one["params"]), leaves(params)))

    # --- resume: a run saved at step 3 and resumed to 6 against an unbroken
    # 6-step run, at the smoke config (bf16 compute, asa16 sharded)
    rcfg = get_smoke_config("llama3.2-1b")
    rmodel = build_model(rcfg, dev)
    rfiles = write_rank_batches(rcfg, rank, k, 2, LM_STEPS,
                                os.path.join(out_dir, f"resume{rank}"),
                                seq=64)
    ck = os.path.join(out_dir, "ckpt")
    finals = []
    for kw in (dict(num_steps=LM_STEPS),
               dict(num_steps=3, ckpt_path=ck, ckpt_every=3),
               dict(num_steps=LM_STEPS, resume_from=ck)):
        rloader = rank_loader(rcfg, rfiles, dev, LM_STEPS, seed=rank)
        st, rrep = train(rmodel, opt, warmup_cosine(0.01, 2, LM_STEPS),
                         rloader, plan=plan, log_every=0, seed=0,
                         print_fn=quiet, **kw)
        rloader.stop()
        finals.append((leaves(st), rrep.steps))
    (a, na), (_, n3), (b, nb) = finals
    out["resume"] = dict(
        steps=[na, n3, nb],
        bitwise_equal=len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) if torch.is_tensor(x)
            else x == y for x, y in zip(a, b)),
        max_abs_diff=max((x.float() - y.float()).abs().max().item()
                         for x, y in zip(a, b) if torch.is_tensor(x)))
    dist.barrier()
    with open(os.path.join(out_dir, f"lm_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def lm_train_phase(device="cuda:0", smoke=False):
    """Spawns the k=2 LM rank processes and checks what they report;
    returns the main run's launches, its (padded, shard) bucket shapes
    and each rank's report (phase 15(c) reads the attribution)."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_lm_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"lm_rank{r}.json").read_text())
                 for r in range(k)]
    print(f"LM train phase: {k} gloo ranks on {device}, {wall:.1f}s")
    for rk in ranks:
        m = rk["main"]
        bad = [x for x in m["losses"] if not math.isfinite(x)]
        if len(m["losses"]) != LM_STEPS or bad:
            _fail(f"LM run rank {rk['rank']}: losses {m['losses']}")
        if m["launches"] != m["predicted"]:
            _fail(f"LM run rank {rk['rank']}: launches {m['launches']} != "
                  f"predicted {m['predicted']}")
        for name in ("flash_attention", "flash_attention_dq",
                     "flash_attention_dkv"):
            if device != "cpu" and rk["k2_launches"].get(name, 0) <= 0:
                _fail(f"the LM k=2 step did not launch {name}")
        r = rk["resume"]
        if r["steps"] != [LM_STEPS, 3, LM_STEPS] or not r["bitwise_equal"]:
            _fail(f"rank {rk['rank']}: resumed run differs from the unbroken "
                  f"one: {r}")
    m = ranks[0]["main"]
    print("LM train run (llama3.2-1b, asa16 sharded): " + json.dumps(
        {key: m[key] for key in (
            "params", "tokens_per_s", "first_step_s", "phase_ms",
            "staged_mb_per_step", "stage_ms_per_step", "wire_ms_per_step",
            "buckets", "launches", "predicted", "losses")}))
    print("LM peak memory per rank, GB: " + json.dumps(
        [rk["main"]["peak_mem_gb"] for rk in ranks]))
    print("LM resume check: " + json.dumps(ranks[0]["resume"]))
    dp = ranks[0]["k2_vs_k1_max_abs_dp"]
    print(f"LM asa step (smoke config, fp32), k=2 on halves vs k=1 on the "
          f"batch: max |dp| {dp} (bound {K_TOL}; the step itself moved "
          f"parameters by up to {ranks[0]['k2_vs_k1_max_abs_step']})")
    if not dp <= K_TOL:
        _fail(f"LM k=2 and k=1 asa steps differ by {dp} > {K_TOL}")
    return (dict(m["launches"]), [tuple(b) for b in m["bucket_shapes"]],
            ranks)


# Phase 8: async (EASGD/ASGD), overlap and hier training. The runs: the
# async plans on full AlexNet, 4 steps each, the centre on asa16; AlexNet
# and llama3.2-1b with overlap="buckets" and with the microbatched sharded
# step beside it; AlexNet on 4 ranks as 2 pods of 2.
ASYNC_RUNS = (("easgd", 1), ("easgd", 2), ("easgd", 4), ("asgd", 2))
ASYNC_STEPS = 4
ASYNC_RTOL, ASYNC_ATOL = 1e-5, 1e-6   # asgd at tau 1 vs BSP at k x lr, as
#                                       the reference's tests/test_engine.py
OVERLAP_STEPS = 4
OVERLAP_MB = 2          # microbatches of every overlap run
LM_OVERLAP_STEPS = 2
LM_OVERLAP_LAYERS = 2   # of llama3.2-1b's 16 (the script has 1200 s)
HIER_PODS, HIER_K = 2, 4
HIER_STEPS = 2
HIER_BATCH = 32         # images a rank


def _async_launches(rsplan, n_leaves: int, steps: int, tau: int):
    """An async asa16 run: fused_sgd on every leaf every step; the centre
    exchange (fp16 RS out, the sum, fp16 AG out and in) on each sync step
    alone."""
    nb = rsplan.num_buckets
    n_sync = sum(1 for i in range(steps) if (i + 1) % tau == 0)
    return {"fused_sgd": n_leaves * steps, "quant_fp16": 2 * nb * n_sync,
            "chunk_sum": nb * n_sync, "dequant_fp16": nb * n_sync}


def _overlap_launches(rsplan, n_leaves: int, steps: int, m: int,
                      fused: bool):
    """An overlapped asa16 run: per microbatch and bucket the fp16 RS out
    and, on the fused route, its receive dequantized to accumulate (else
    its chunk_sum); once a step and bucket the update (fused_rs_update,
    or fused_sgd on the shard) and the fp16 parameter AG out and in."""
    nb, ns = rsplan.num_buckets, len(rsplan.small)
    if fused:
        per_step = {"quant_fp16": nb * (m + 1), "dequant_fp16": nb * (m + 1),
                    "fused_rs_update": nb, "fused_sgd": ns}
    else:
        per_step = {"quant_fp16": nb * (m + 1), "chunk_sum": nb * m,
                    "dequant_fp16": nb, "fused_sgd": nb + ns}
    return {n: c * steps for n, c in per_step.items() if c}


def _ms(split: dict) -> dict:
    return {p: v * 1e3 for p, v in split.items()}


def _kind_ms(by_kind: dict) -> dict:
    """The loop's by_kind means, in ms and MB, with the whole step's ms."""
    return {kind: {"steps": v["steps"],
                   "step_ms": (v["fwd_bwd"] + v["exchange"]
                               + v["update"]) * 1e3,
                   "fwd_bwd_ms": v["fwd_bwd"] * 1e3,
                   "exchange_ms": v["exchange"] * 1e3,
                   "update_ms": v["update"] * 1e3,
                   "stage_ms": v["stage_s"] * 1e3,
                   "wire_ms": v["wire_s"] * 1e3,
                   "staged_mb": v["staged_bytes"] / 1e6}
            for kind, v in by_kind.items()}


def _max_dp(torch, a, b) -> float:
    from repro_torch.tree import leaves
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(leaves(a), leaves(b)))


def _run_report(torch, rep, launches, predicted, cuda) -> dict:
    """A run's rates, device split, transport counters and launches, with
    the host's mean wait for a batch and its mean wall time a steady step
    (the loop's ``train/data_time_s`` and ``train/step_time_s``)."""
    h_data, h_step = (rep.metrics["train/data_time_s"],
                      rep.metrics["train/step_time_s"])
    return dict(
        steps=rep.steps, losses=rep.losses,
        data_wait_ms=h_data.sum / max(h_data.count, 1) * 1e3,
        step_wall_ms=h_step.sum / max(h_step.count, 1) * 1e3,
        images_per_s=rep.steady_examples_per_s,
        tokens_per_s=rep.steady_tokens_per_s,
        first_step_s=rep.first_step_time, phase_ms=_ms(rep.phase_s),
        staged_mb_per_step=rep.staged_bytes / 1e6,
        stage_ms_per_step=rep.stage_s * 1e3,
        wire_ms_per_step=rep.wire_s * 1e3,
        exposed_wait_ms_per_step=rep.exposed_s * 1e3,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                     else None),
        launches=launches, predicted=predicted)


def _phase8_rank(rank, k, out_dir, device, smoke):
    """One of the two ranks of phase 8's async and overlap runs."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import constant, sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan, plan_wire
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    quiet = lambda *a: None
    out = {"rank": rank}

    def run(model, cfg, files, plan, steps, opt_lr, predicted):
        """``predicted``: the launches, or a function of the trained
        parameters that gives them."""
        opt, lr = opt_lr
        loader = rank_loader(cfg, files, dev, steps, seed=rank)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        st, rep = train(model, opt, lr, loader, plan=plan, num_steps=steps,
                        log_every=steps, seed=0, print_fn=quiet)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        if callable(predicted):
            predicted = predicted(st["params"])
        del st
        res = _run_report(torch, rep, launches, predicted, cuda)
        res["by_kind"] = _kind_ms(rep.by_kind)
        return res

    # --- EASGD/ASGD on full AlexNet, the centre on asa16
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    rsplan = exchanger.make_rs_plan(shapes, k)
    n_leaves = len(leaves(shapes))
    batch = 4 if smoke else 128
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"data{rank}"))
    out["async"] = {}
    for algo, tau in ASYNC_RUNS:
        plan = TrainPlan(algo=algo, tau=tau, exchanger="asa16")
        res = run(model, cfg, files, plan, ASYNC_STEPS,
                  recipe(cfg, ASYNC_STEPS),
                  _plus(_async_launches(rsplan, n_leaves, ASYNC_STEPS, tau),
                        _halves_launches(rsplan, "asa16",
                                         _tree_bytes(shapes), k)))
        res["wire_bytes_per_step"] = plan_wire(plan, shapes, k)[
            "bytes_per_step"]
        res["tau"] = tau
        out["async"][f"{algo} tau={tau}"] = res
    # --- the overlap on full AlexNet beside the microbatched sharded step
    out["overlap"] = {}
    for name, kw in (("overlap", dict(overlap="buckets")),
                     ("sharded", dict(sharded_update=True))):
        plan = TrainPlan(exchanger="asa16", microbatches=OVERLAP_MB, **kw)
        pred = _plus(_overlap_launches(rsplan, n_leaves, OVERLAP_STEPS,
                                       OVERLAP_MB, cuda) if plan.overlap
                     else _predicted_launches(rsplan, n_leaves, "asa16",
                                              True, OVERLAP_STEPS, cuda, k),
                     _halves_launches(rsplan, "asa16", _tree_bytes(shapes),
                                      k))
        out["overlap"][name] = run(model, cfg, files, plan, OVERLAP_STEPS,
                                   recipe(cfg, OVERLAP_STEPS), pred)
    del model
    if cuda:
        torch.cuda.empty_cache()

    # --- the smoke config, fp32 asa, cuDNN off (its fp32 weight gradient
    # errs by ~1 % of the scale, differently per batch; see the c2 line)
    solo = dist.new_group([0])
    scfg = get_smoke_config("alexnet")
    smodel = build_model(scfg, dev)
    sfiles = write_rank_batches(scfg, rank, k, 4, 6,
                                os.path.join(out_dir, f"smoke{rank}"))
    sgd = sgd_momentum(momentum=0.9, weight_decay=5e-4,
                       fused_kernel=fs.fused_sgd)
    with torch.backends.cudnn.flags(enabled=False):
        # asgd at tau 1 from a synced start against BSP at k x the lr
        finals = {}
        for name, plan, lr in (
                ("asgd", TrainPlan(algo="asgd", exchanger="asa"), 0.01),
                ("bsp", TrainPlan(exchanger="asa"), 0.01 * k)):
            loader = rank_loader(scfg, sfiles, dev, 3, seed=rank)
            st, _ = train(smodel, sgd, constant(lr), loader, plan=plan,
                          num_steps=3, log_every=0, seed=0, print_fn=quiet)
            loader.stop()
            finals[name] = st
        worst = max(((x.float() - y.float()).abs()
                     - (ASYNC_ATOL + ASYNC_RTOL * y.float().abs())).max()
                    .item() for x, y in zip(leaves(finals["asgd"]["center"]),
                                            leaves(finals["bsp"]["params"])))
        out["asgd_vs_bsp"] = {
            "max_abs_diff": _max_dp(torch, finals["asgd"]["center"],
                                    finals["bsp"]["params"]),
            "worst_excess": worst,
            "snapped": _max_dp(torch, finals["asgd"]["params"],
                               finals["asgd"]["center"]) == 0.0}
        # resume inside a tau-2 window: saved at 3, resumed to 6
        plan = TrainPlan(algo="easgd", tau=2, exchanger="asa16")
        ck = os.path.join(out_dir, "async_ckpt")
        states = []
        for kw in (dict(num_steps=6), dict(num_steps=3, ckpt_path=ck,
                                           ckpt_every=3),
                   dict(num_steps=6, resume_from=ck)):
            loader = rank_loader(scfg, sfiles, dev, 6, seed=rank)
            st, rep = train(smodel, sgd, constant(0.01), loader, plan=plan,
                            log_every=0, seed=0, print_fn=quiet, **kw)
            loader.stop()
            states.append((st, rep.steps))
        (a, na), (_, n3), (b, nb) = states
        out["async_resume"] = dict(
            steps=[na, n3, nb],
            bitwise_equal=all(
                x.dtype == y.dtype and torch.equal(x, y)
                for part in ("params", "opt", "center")
                for x, y in zip(leaves(a[part]), leaves(b[part]))))
        # the overlapped step against the microbatched one (k=2) and
        # against a group of one on the whole batch (k=1)
        src = ImageSource(scfg.image_size, scfg.num_classes)
        full = {n_: torch.from_numpy(v).to(dev)
                for n_, v in src.batch(4, 4321).items()}
        half = {n_: v[rank * 2:(rank + 1) * 2] for n_, v in full.items()}
        asa = exchanger.get_exchanger("asa")
        gen7 = lambda: torch.Generator(device=dev).manual_seed(7)
        s0 = bsp.init_sharded_train_state(smodel, sgd, gen7())
        K.reset_launches()
        ovl, _ = bsp.make_bsp_step(smodel, sgd, asa, constant(0.01),
                                   overlap="buckets",
                                   microbatches=OVERLAP_MB)(s0, half)
        out["overlap_smoke_launches"] = dict(K.LAUNCHES)
        mb, _ = bsp.make_bsp_step(smodel, sgd, asa, constant(0.01),
                                  sharded_update=True,
                                  microbatches=OVERLAP_MB)(s0, half)
        out["overlap_vs_mb_max_abs_dp"] = _max_dp(torch, ovl["params"],
                                                  mb["params"])
        if rank == 0:
            s1 = bsp.init_sharded_train_state(smodel, sgd, gen7(), solo)
            one, _ = bsp.make_bsp_step(
                smodel, sgd, asa, constant(0.01), group=solo,
                overlap="buckets", microbatches=OVERLAP_MB)(s1, full)
            out["overlap_k2_vs_k1_max_abs_dp"] = _max_dp(
                torch, ovl["params"], one["params"])
            out["overlap_max_abs_step"] = _max_dp(torch, one["params"],
                                                  s1["params"])
    del smodel
    if cuda:
        torch.cuda.empty_cache()

    # --- llama3.2-1b at full width, cut to LM_OVERLAP_LAYERS, with and
    # without the overlap, 2 x (2 x 1024) tokens a rank, asa16, the fused
    # RS tail
    lcfg = (get_smoke_config("llama3.2-1b") if smoke else get_config(
        "llama3.2-1b").with_overrides(num_layers=LM_OVERLAP_LAYERS))
    lmodel = build_model(lcfg, dev)
    lbatch, lseq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    lfiles = write_rank_batches(lcfg, rank, k, lbatch, LM_OVERLAP_STEPS,
                                os.path.join(out_dir, f"lm{rank}"), seq=lseq)
    L, m = lcfg.num_layers, OVERLAP_MB
    flash = dict(flash_attention=(2 if lcfg.remat else 1) * L * m *
                 LM_OVERLAP_STEPS, flash_attention_dq=L * m *
                 LM_OVERLAP_STEPS, flash_attention_dkv=L * m *
                 LM_OVERLAP_STEPS)
    out["lm"] = {}
    lm_opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                          fused_kernel=fs.fused_sgd)
    def lm_predicted(overlap):
        def of(params):
            lplan = exchanger.make_rs_plan(params, k)
            n = len(leaves(params))
            pred = (_overlap_launches(lplan, n, LM_OVERLAP_STEPS, m, cuda)
                    if overlap else _predicted_launches(
                        lplan, n, "asa16", True, LM_OVERLAP_STEPS, cuda, k))
            return _plus(pred, flash, _halves_launches(
                lplan, "asa16", _tree_bytes(params), k))
        return of

    for name, kw in (("overlap", dict(overlap="buckets")),
                     ("sharded", dict(sharded_update=True))):
        plan = TrainPlan(exchanger="asa16", microbatches=m, **kw)
        out["lm"][name] = run(
            lmodel, lcfg, lfiles, plan, LM_OVERLAP_STEPS,
            (lm_opt, warmup_cosine(0.01, 2, LM_OVERLAP_STEPS)),
            lm_predicted(plan.overlap))
    dist.barrier()
    with open(os.path.join(out_dir, f"p8_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _hier_rank(rank, k, out_dir, device, smoke):
    """One of the 4 ranks (2 pods of 2) of phase 8's hier runs."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    out = {"rank": rank}
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    per_pod = k // HIER_PODS
    rsplan = exchanger.make_rs_plan(shapes, per_pod)
    n_leaves = len(leaves(shapes))
    batch = 2 if smoke else HIER_BATCH
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"hier{rank}"))
    out["runs"] = {}
    for name, ex, sharded in (("hier16 sharded", "hier16", True),
                              ("hier", "hier", False)):
        plan = TrainPlan(exchanger=ex, sharded_update=sharded,
                         data_axes=("pod", "data"))
        opt, lr = recipe(cfg, HIER_STEPS)
        loader = rank_loader(cfg, files, dev, HIER_STEPS, seed=rank)
        K.reset_launches()
        _, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=HIER_STEPS, log_every=HIER_STEPS, seed=0,
                       pods=HIER_PODS, print_fn=lambda *a: None)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        res = _run_report(torch, rep, launches, _plus(
            _predicted_launches(rsplan, n_leaves, ex, sharded, HIER_STEPS,
                                False, per_pod),
            _halves_launches(rsplan, ex, _tree_bytes(shapes), per_pod)),
            cuda)
        res["cross_pod_wire_ms_per_step"] = rep.lead_wire_s * 1e3
        out["runs"][name] = res
    # one hier fp32 step of the 4 ranks on quarters against a group of one
    # on the whole batch, at the smoke config with cuDNN off
    solo = dist.new_group([0])
    tr = exchanger.make_transport(("pod", "data"), HIER_PODS)
    scfg = get_smoke_config("alexnet")
    smodel = build_model(scfg, dev)
    src = ImageSource(scfg.image_size, scfg.num_classes)
    full = {n_: torch.from_numpy(v).to(dev)
            for n_, v in src.batch(k, 999).items()}
    mine = {n_: v[rank:rank + 1] for n_, v in full.items()}
    opt, _ = recipe(scfg, 1)
    params = smodel.init(torch.Generator(device=dev).manual_seed(7))
    state = {"params": params, "opt": opt.init(params), "step": 0}
    with torch.backends.cudnn.flags(enabled=False):
        four, _ = bsp.make_bsp_step(smodel, opt,
                                    exchanger.get_exchanger("hier"),
                                    constant(0.01), tr)(state, mine)
        if rank == 0:
            one, _ = bsp.make_bsp_step(smodel, opt,
                                       exchanger.get_exchanger("asa"),
                                       constant(0.01), solo)(state, full)
            out["k4_vs_k1_max_abs_dp"] = _max_dp(torch, four["params"],
                                                 one["params"])
            out["k4_vs_k1_max_abs_step"] = _max_dp(torch, one["params"],
                                                   params)
    dist.barrier()
    with open(os.path.join(out_dir, f"hier_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _check_runs(label, ranks, key, want_steps):
    """Finite losses of the expected length and launches equal to the
    prediction, on every rank, for each run under ``key``."""
    for rk in ranks:
        for name, rr in rk[key].items():
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != want_steps or bad:
                _fail(f"{label} {name} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if rr["launches"] != rr["predicted"]:
                _fail(f"{label} {name} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")


def _sum_launches(runs) -> dict:
    total = {}
    for rr in runs:
        for name, c in rr["launches"].items():
            total[name] = total.get(name, 0) + c
    return total


_SHOW = ("images_per_s", "tokens_per_s", "first_step_s", "step_wall_ms",
         "data_wait_ms", "phase_ms",
         "exposed_wait_ms_per_step", "wire_ms_per_step", "stage_ms_per_step",
         "staged_mb_per_step", "peak_mem_gb", "launches", "predicted",
         "losses")


def async_phase(device="cuda:0", smoke=False):
    """Phase 8: spawns the 2 ranks of the async and overlap runs, then the
    4 of the hier runs, and checks what they report; returns the launches
    of each path (rank 0's, each run counted from zero)."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_phase8_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"p8_rank{r}.json").read_text())
                 for r in range(k)]
        t1 = time.perf_counter()
        run_ranks(_hier_rank, HIER_K, (td, device, smoke), backend="gloo")
        hwall = time.perf_counter() - t1
        hranks = [json.loads(Path(td, f"hier_rank{r}.json").read_text())
                  for r in range(HIER_K)]
    print(f"async and overlap phase: {k} gloo ranks on {device}, "
          f"{wall:.1f}s; hier phase: {HIER_K} ranks as {HIER_PODS} pods, "
          f"{hwall:.1f}s")
    _check_runs("async", ranks, "async", ASYNC_STEPS)
    _check_runs("AlexNet overlap", ranks, "overlap", OVERLAP_STEPS)
    _check_runs("LM overlap", ranks, "lm", LM_OVERLAP_STEPS)
    _check_runs("hier", hranks, "runs", HIER_STEPS)
    r0 = ranks[0]
    for rk in ranks:
        for name, rr in rk["async"].items():
            local = rr["by_kind"].get("local")
            if (rr["tau"] > 1) != (local is not None) or (
                    local is not None and any(local[c] != 0.0 for c in (
                        "staged_mb", "stage_ms", "wire_ms"))):
                _fail(f"async {name} rank {rk['rank']}: a local step moved "
                      f"the transport's counters: {rr['by_kind']}")
    for name, rr in r0["async"].items():
        print(f"async run ({name}, asa16 centre), {ASYNC_STEPS} steps: "
              + json.dumps({key: rr[key] for key in (
                  "images_per_s", "first_step_s", "step_wall_ms",
                  "data_wait_ms", "by_kind",
                  "wire_bytes_per_step", "launches", "predicted",
                  "losses")}))
    a = r0["asgd_vs_bsp"]
    print(f"asgd tau=1 vs BSP at k x lr (smoke config, fp32 asa, 3 steps): "
          f"max |dc| {a['max_abs_diff']}, worst excess over rtol "
          f"{ASYNC_RTOL} / atol {ASYNC_ATOL}: {a['worst_excess']}; workers "
          f"snapped to the centre: {a['snapped']}")
    for rk in ranks:
        if not (rk["asgd_vs_bsp"]["worst_excess"] <= 0.0
                and rk["asgd_vs_bsp"]["snapped"]):
            _fail(f"rank {rk['rank']}: asgd at tau 1 differs from BSP at "
                  f"k x lr: {rk['asgd_vs_bsp']}")
        r = rk["async_resume"]
        if r["steps"] != [6, 3, 6] or not r["bitwise_equal"]:
            _fail(f"rank {rk['rank']}: the easgd run resumed inside its "
                  f"tau window differs from the unbroken one: {r}")
    print("async resume check (easgd tau 2, saved at 3, resumed to 6): "
          + json.dumps(r0["async_resume"]))
    for group in ("overlap", "lm"):
        for name, rr in r0[group].items():
            print(f"{'AlexNet' if group == 'overlap' else 'LM'} run "
                  f"({name}, asa16, {OVERLAP_MB} microbatches): "
                  + json.dumps({key: rr[key] for key in _SHOW}))
    dp = max(rk["overlap_vs_mb_max_abs_dp"] for rk in ranks)
    dk = r0["overlap_k2_vs_k1_max_abs_dp"]
    print(f"overlap step (smoke config, fp32 asa): vs the microbatched "
          f"sharded step max |dp| {dp}, k=2 vs k=1 max |dp| {dk} (bound "
          f"{K_TOL}; the step moved parameters by up to "
          f"{r0['overlap_max_abs_step']}); launches "
          + json.dumps(r0["overlap_smoke_launches"]))
    if not (dp <= K_TOL and dk <= K_TOL):
        _fail(f"the overlapped step differs: vs microbatched {dp}, k=2 vs "
              f"k=1 {dk} > {K_TOL}")
    h0 = hranks[0]
    for name, rr in h0["runs"].items():
        print(f"hier run ({name}, 2 pods x 2, {HIER_BATCH} a rank): "
              + json.dumps({key: rr[key] for key in _SHOW + (
                  "cross_pod_wire_ms_per_step",)}))
    dh = h0["k4_vs_k1_max_abs_dp"]
    print(f"hier step (smoke config, fp32), 4 ranks on quarters vs k=1 on "
          f"the batch: max |dp| {dh} (bound {K_TOL}; the step moved "
          f"parameters by up to {h0['k4_vs_k1_max_abs_step']})")
    if not dh <= K_TOL:
        _fail(f"hier: 4 ranks and a group of one differ by {dh} > {K_TOL}")
    return {"easgd_train": _sum_launches(r0["async"].values()),
            "overlap_train": _sum_launches(r0["overlap"].values()),
            "lm_overlap_train": _sum_launches(r0["lm"].values()),
            "hier_train": _sum_launches(h0["runs"].values())}


ELASTIC_SLOTS = 4
ELASTIC_BATCH = 32      # images a worker and step (phase 8's hier run's)
ELASTIC_STEPS = 40
ELASTIC_POOL = 4        # batches a slot draws once and indexes by step
ELASTIC_SPEC = "kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33"
# the reference's figures for this spec (its tests/test_fault.py)
ELASTIC_COUNTS = dict(kills=1, joins=1, rebuilds=2, payloads_corrupt=1,
                      payloads_dropped=1, rounds_skipped_quorum=0)


def _elastic_step_launches(rsplan_of, n_leaves: int, k: int, sync: bool):
    """One elastic asa16 step of a live slot: fused_sgd on every leaf; on a
    synced round the centre exchange at that round's k (fp16 RS out, the
    sum, fp16 AG out and in), whatever the slot's weight."""
    if not sync:
        return {"fused_sgd": n_leaves}
    return _async_launches(rsplan_of(k), n_leaves, 1, 1)


def _phase9_rank(rank, k, out_dir, device, smoke):
    """One of the 4 slots of phase 9: elastic EASGD of full AlexNet through
    the chaos spec, then the fault smoke's properties at its config."""
    import os

    import torch

    from repro_torch import kernels as K
    from repro_torch import telemetry
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fault import smoke as fsmoke
    from repro_torch.fault.elastic import elastic_train
    from repro_torch.launch.train import (elastic_batch_fn, recipe,
                                          set_fp32_math)
    from repro_torch.models import build_model
    from repro_torch.train.engine import TrainPlan

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    telemetry.configure(metrics_out=os.path.join(
        out_dir, f"metrics_slot{rank}.jsonl"))
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    # a pool of this slot's batches, drawn once on the host and indexed by
    # (step + row): deterministic in both, and no global batch is drawn
    own = elastic_batch_fn(cfg, 8 if smoke else ELASTIC_BATCH, 0,
                           ELASTIC_SLOTS, dev, pool=ELASTIC_POOL)
    marks = []          # (step, k, launches so far) at each live step

    def batch_fn(step, kk, row):
        marks.append((step, kk, dict(K.LAUNCHES)))
        return own(step, kk, row)

    plan = TrainPlan(algo="easgd", tau=4, alpha=0.5, exchanger="asa16",
                     quorum=2)
    opt, lr = recipe(cfg, ELASTIC_STEPS)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = elastic_train(model, opt, lr, batch_fn, plan=plan,
                               num_steps=ELASTIC_STEPS, seed=0,
                               fault_plan=ELASTIC_SPEC, log_every=0,
                               print_fn=None)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    out = {"rank": rank, "worker": rep.worker, "steps": rep.steps,
           "losses": rep.losses, "wall_s": rep.wall_time,
           "round_log": rep.round_log, "final_workers": rep.final_workers,
           "counts": {f: getattr(rep, f) for f in (
               "kills", "joins", "rebuilds", "payloads_corrupt",
               "payloads_dropped", "rounds_skipped_quorum", "rounds_synced",
               "straggles")},
           "rebuild_log": rep.rebuild_log, "by_kind": rep.by_kind,
           "marks": [(s, kk) for s, kk, _ in marks],
           "step_launches": [
               {n: c - a.get(n, 0) for n, c in (
                   marks[j + 1][2] if j + 1 < len(marks) else launches
               ).items() if c - a.get(n, 0)}
               for j, (_, _, a) in enumerate(marks)],
           "launches": launches,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None)}
    del state, model, own
    if cuda:
        torch.cuda.empty_cache()
    # the fault smoke's properties at its own config, on this device
    res_dir = os.path.join(out_dir, "smoke")
    os.makedirs(res_dir, exist_ok=True)
    opts = dict(device=str(dev), out=None, steps=48,
                workers=ELASTIC_SLOTS, tau=4, quorum=2,
                fault_plan=fsmoke.CHAOS, res_dir=res_dir)
    t0 = time.perf_counter()
    fsmoke._rank(rank, k, opts, os.path.join(out_dir, "smoke_ck"))
    out["smoke_s"] = time.perf_counter() - t0
    telemetry.flush(force=True)
    telemetry.trace.export(os.path.join(out_dir, f"trace_slot{rank}.json"))
    with open(os.path.join(out_dir, f"p9_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def elastic_phase(device="cuda:0", smoke=False):
    """Phase 9: spawns the 4 slots of the elastic run and checks what they
    report; returns the elastic path's launches (slot 0's) and, for each k
    of its synced rounds, the centre exchange's (padded, shard) buckets."""
    import os
    import tempfile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import exchanger
    from repro_torch.fault import smoke as fsmoke
    from repro_torch.launch.train import run_ranks
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    shapes = build_model(cfg, "meta").init(None)
    n_leaves = len(leaves(shapes))
    plans = {}

    def rsplan_of(kk):
        if kk not in plans:
            plans[kk] = exchanger.make_rs_plan(shapes, kk)
        return plans[kk]

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_phase9_rank, ELASTIC_SLOTS, (td, device, smoke),
                  backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"p9_rank{r}.json").read_text())
                 for r in range(ELASTIC_SLOTS)]
        smoke_ranks = [json.loads(Path(td, "smoke", f"smoke{r}.json")
                                  .read_text())
                       for r in range(ELASTIC_SLOTS)]
        val = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry.validate",
             os.path.join(td, "metrics_slot0.jsonl"), "--trace",
             os.path.join(td, "trace_slot0.json")], capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    r0 = ranks[0]
    print(f"elastic phase: {ELASTIC_SLOTS} gloo slots on {device}, "
          f"{wall:.1f}s (the fault smoke's four runs at its config "
          f"{r0['smoke_s']:.1f}s of it)")
    for rk in ranks:
        counts = {n: rk["counts"][n] for n in ELASTIC_COUNTS}
        if counts != ELASTIC_COUNTS or rk["final_workers"] != [0, 1, 2, 3]:
            _fail(f"elastic slot {rk['rank']}: counts {rk['counts']}, "
                  f"final workers {rk['final_workers']}")
        (w23,) = [(rep, w) for s, rep, w in rk["round_log"] if s == 23]
        if not (w23[0] == [0, 2] and w23[1][:2] == [0.5, 0.0]
                and abs(w23[1][2] - 0.5 / 3) < 1e-7):
            _fail(f"elastic slot {rk['rank']}: the step-23 round {w23}")
        bad = [x for x in rk["losses"] if not math.isfinite(x)]
        if len(rk["losses"]) != ELASTIC_STEPS or bad:
            _fail(f"elastic slot {rk['rank']}: losses {rk['losses']}")
        # every live step's launches, against the step's prediction at its
        # k; a slot's idle steps fall between two marks and must add none
        synced = {s for s, _, _ in rk["round_log"]}
        for (s, kk), got in zip(rk["marks"], rk["step_launches"]):
            want = _elastic_step_launches(rsplan_of, n_leaves, kk,
                                          s in synced)
            if got != want:
                _fail(f"elastic slot {rk['rank']} step {s} (k={kk}): "
                      f"launches {got} != predicted {want}")
        local = rk["by_kind"].get("local", {})
        if any(local.get(c, 0.0) != 0.0 for c in ("staged_bytes", "stage_s",
                                                    "wire_s")):
            _fail(f"elastic slot {rk['rank']}: a local step moved the "
                  f"transport's counters: {rk['by_kind']}")
    for rk in ranks:
        ran = {s for s, _ in rk["marks"]}
        idle = [s for s in range(ELASTIC_STEPS) if s not in ran]
        print(f"elastic slot {rk['rank']}: {len(ran)} live steps, idle at "
              f"steps {idle or 'none'} (launches there: none, checked); "
              f"worker at the end {rk['worker']}")
    images = sum(len(rk["marks"]) for rk in ranks) * (
        8 if smoke else ELASTIC_BATCH)
    wall_run = max(rk["wall_s"] for rk in ranks)
    bk = r0["by_kind"]
    print(f"elastic run (full AlexNet, easgd tau 4 alpha 0.5 quorum 2, "
          f"asa16 centre, {ELASTIC_BATCH} images a worker, "
          f"{ELASTIC_STEPS} steps, spec {ELASTIC_SPEC}): "
          + json.dumps({
              "images_per_s": images / wall_run, "wall_s": wall_run,
              "local_step_ms": _kind_ms({"local": bk["local"]})["local"],
              "sync_round_ms": _kind_ms({"sync": bk["sync"]})["sync"],
              "peak_mem_gb_slot0": r0["peak_mem_gb"],
              "counts": r0["counts"], "final_workers": r0["final_workers"],
              "losses": r0["losses"]}))
    # a slot that was idle waits in new_group for the live ones: slot 0
    # (live throughout) times the group and sends the centre; the
    # joiner's optimizer.init is its own
    for j, rb in enumerate(r0["rebuild_log"]):
        init_ms = max(rk["rebuild_log"][j]["opt_init_s"] for rk in ranks)
        print(f"elastic rebuild at step {rb['step']}: {rb['old']} -> "
              f"{rb['new']}, new_group {rb['new_group_s'] * 1e3:.1f} ms, "
              f"centre broadcast {rb['broadcast_s'] * 1e3:.1f} ms, the "
              f"joiner's optimizer.init {init_ms * 1e3:.1f} ms (slot 0's "
              f"view; a synced round takes "
              f"{_kind_ms({'s': bk['sync']})['s']['step_ms']:.1f} ms)")
    per_k = {}
    for s, rep, _ in r0["round_log"]:
        kk = dict(r0["marks"])[s]
        per_k.setdefault(kk, []).append(s)
    print("elastic synced rounds by k, each round's predicted launches: "
          + json.dumps({kk: {"rounds": steps, "launches":
                             _elastic_step_launches(rsplan_of, n_leaves, kk,
                                                    True)}
                        for kk, steps in per_k.items()}))
    print("elastic round_log: " + json.dumps(r0["round_log"]))
    failures = fsmoke.check(smoke_ranks, 48, print_fn=lambda s: print(
        f"elastic smoke config on {device}: {s}"))
    if failures:
        _fail(f"the fault smoke's properties failed on {device}: "
              f"{failures}")
    print(f"telemetry validate (slot 0's metrics JSONL and trace): "
          f"{val.stdout.strip()} {val.stderr.strip()}")
    if val.returncode != 0:
        _fail("slot 0's telemetry does not validate")
    return {"elastic": r0["launches"]}, {
        kk: [(b.padded, b.shard_len) for b in rsplan_of(kk).buckets]
        for kk in sorted(per_k)}


# ---------------------------------------------------------------------------
# phase 10: the serve guardrails under the chaos loop
# ---------------------------------------------------------------------------

CHAOS_PLAN = "qflood:6@3,stall:8@6x4,cancel:1@9,pagepress:12@10x8"
CHAOS_FLOOR = 20        # the reference CLI's --goodput-floor (its docstring)
CHAOS_SHAPE = dict(max_slots=4, max_seq=64, prefill_chunk=8, page_size=8,
                   max_queue=16, shed_policy="reject-no-deadline",
                   fused_sampling=True)
CHAOS_POSITIONS = (5, 17, 40, 63)   # 4 slots over 64-key lanes, pages of 8
# what the reference CLI prints for the plan (its counts do not depend on
# token values, nor the workload on the vocabulary's size)
CHAOS_COUNTS = dict(submitted=14, rejected_at_submit=0, finished_total=14,
                    shed=3, cancelled=1, deadline_misses=6,
                    rejected_queue_full=0, watchdog_stalls=1,
                    brownout_clamped=0, goodput_tokens=38,
                    decoded_tokens=48, steps=18)


class _FirstCalls:
    """Patches ``module.name`` for each (module, name) with a pass-through
    that keeps clones of the arguments of its first call at each argument
    shape (the shapes the path gives the kernel); restores on exit."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.calls = torch, targets, {}

    def _clone(self, x):
        return x.clone() if isinstance(x, self.torch.Tensor) else x

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            real = getattr(mod, name)
            self.saved.append((mod, name, real))

            def spy(*a, _real=real, _name=name, **kw):
                key = (_name,) + tuple(tuple(x.shape) for x in a
                                       if isinstance(x, self.torch.Tensor))
                if key not in self.calls:
                    self.calls[key] = ([self._clone(x) for x in a],
                                       {k: self._clone(v)
                                        for k, v in kw.items()})
                return _real(*a, **kw)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def _hold_path_calls(torch, ref, fa, sg, calls) -> dict:
    """Each kernel wrapper against its plain version on the arguments the
    chaos path gave it (first call at each shape). Returns {call: max
    abs err}."""
    errs = {}
    for key, (a, kw) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        name = key[0]
        if name == "flash_attention":
            q, k, v = a
            off = fa._positions(kw.get("q_off"), q.shape[0], q.device)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, off, kw.get("window", 0),
                                           1 / math.sqrt(q.shape[-1]))
            tol = FWD_TOL
        elif name == "flash_decode_paged":
            q, kp, vp, tables, pos = a
            got = fa.flash_decode_paged(q, kp, vp, tables, pos, **kw)
            want = ref.flash_decode_paged_ref(
                q, kp, vp, tables, fa._positions(pos, q.shape[0], q.device),
                kw.get("window", 0), 1 / math.sqrt(q.shape[-1]),
                kw["page_size"])
            tol = DECODE_TOL
        else:                                   # slot_gather_sample
            got = torch.stack(sg.slot_gather_sample(*a))
            want = torch.stack(ref.slot_gather_sample_ref(*a))
            tol = 0
        err = (got.float() - want.float()).abs().max().item()
        label = f"{name}{list(key[1:])}"
        errs[label] = err
        if not err <= tol:
            _fail(f"chaos path: {label} vs plain: max err {err} > {tol}")
    return errs


def chaos_phase(torch, K, cfg, models, serve, dev):
    """Phase 10: ``serve.chaos`` on ``cfg`` (random weights from a seeded
    generator, bf16) at the reference CLI's engine shape and plan, seed 0,
    8 base requests: ``verify_replay`` (two runs, one digest), then
    ``verify_drain_restore``. Returns the launches of the phase's run."""
    import numpy as np
    from repro_torch.fault.inject import FaultPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import slot_gather as sg
    from repro_torch.models import attention
    from repro_torch.serve import chaos
    from repro_torch.serve import engine as engine_mod

    # the split-KV decode at this shape alone first: B 4, 64-key lanes
    g = torch.Generator(device=dev).manual_seed(10)
    a = cfg.attention
    rows = _serve_decode(torch, ref, fa, g, a.num_heads, a.num_kv_heads,
                         a.head_dim, torch.bfloat16, None, CHAOS_POSITIONS,
                         64, dev=str(dev), ps=8)
    print("chaos shape decode vs plain (4 slots over 64 keys, pages of 8): "
          + json.dumps({n: r["err"] for n, r in rows.items()}))

    model = models.build_model(cfg, dev)
    master = model.init(torch.Generator(device=dev).manual_seed(0))
    params = models.cast_params(master, torch.bfloat16)
    del master
    host_s = []

    def make_engine(**over):
        eng = serve.Engine(model, params, device=dev, **CHAOS_SHAPE, **over)
        dispatch, first = eng._decode, [True]

        def timed(*args):          # host time of a decode step, to its sync
            t = time.perf_counter()
            out = dispatch(*args)
            if not first[0]:       # an engine's first step sets up
                host_s.append(time.perf_counter() - t)
            first[0] = False
            return out
        eng._decode = timed        # (no reference back to eng: no cycle)
        return eng

    plan = FaultPlan.from_spec(CHAOS_PLAN, seed=0)
    run_kw = dict(n_base=8, max_steps=300, vocab=cfg.vocab_size, max_seq=64)
    targets = [(attention, "flash_attention"),
               (attention, "flash_decode_paged"),
               (engine_mod, "slot_gather_sample")]
    _sync(torch, dev)
    K.reset_launches()
    t0 = time.perf_counter()
    with _FirstCalls(torch, targets) as spy:
        res, _ = chaos.verify_replay(make_engine, plan, **run_kw)
        t1 = time.perf_counter()
        drain = chaos.verify_drain_restore(make_engine, seed=0,
                                           vocab=cfg.vocab_size, max_seq=64)
    _sync(torch, dev)
    t2 = time.perf_counter()
    launches = dict(K.LAUNCHES)
    # what trace_counts costs a decode step: the signature of its arguments
    eng = make_engine()
    sig_us = 1e3 * _host_ms(lambda: engine_mod._signature(
        (eng.params, eng.pool)), iters=200)
    del eng
    for name in ("flash_attention", "flash_decode_paged",
                 "flash_decode_combine", "slot_gather_sample"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was not launched by the chaos path")
    s = res["stats"]
    levels = sorted({e["brownout"] for e in res["log"]})
    out = dict(
        plan=CHAOS_PLAN, seed=0, digest=res["digest"],
        counts={k: s[k] for k in CHAOS_COUNTS},
        log_len=len(res["log"]), brownout_levels=levels,
        decode_compiles=res["decode_compiles"],
        replay_wall_s=t1 - t0, drain_restore_wall_s=t2 - t1,
        decode_steps_timed=len(host_s),
        decode_host_ms_mean=1e3 * float(np.mean(host_s)),
        decode_host_ms_p50=1e3 * float(np.median(host_s)),
        signature_host_us=sig_us,
        requeued=drain["requeued"], launches=launches)
    print(f"chaos phase ({cfg.name}, bf16, paged, fused sampling): "
          + json.dumps(out))
    if res["decode_compiles"] != 1:
        _fail(f"chaos: the decode saw {res['decode_compiles']} argument "
              f"signatures, not 1")
    if out["counts"] != CHAOS_COUNTS:
        _fail(f"chaos: counts {out['counts']} are not the reference "
              f"CLI's {CHAOS_COUNTS}")
    if s["goodput_tokens"] < CHAOS_FLOOR:
        _fail(f"chaos: goodput {s['goodput_tokens']} < {CHAOS_FLOOR}")
    if s["finished_total"] != s["submitted"] - s["rejected_at_submit"]:
        _fail(f"chaos: {s['finished_total']} terminal of "
              f"{s['submitted']} - {s['rejected_at_submit']} accepted")
    if not drain["requeued"]:
        _fail("chaos: the drain left nothing to restore")
    errs = _hold_path_calls(torch, ref, fa, sg, spy.calls)
    print("chaos path kernels vs plain, at the path's first call of each "
          "shape: " + json.dumps(errs))
    return launches


# ---------------------------------------------------------------------------
# Phase 11: DeepSeek-V2-Lite (MLA + fine-grained MoE)
# ---------------------------------------------------------------------------

DS_ARCH = "deepseek-v2-lite-16b"
DS_PARAMS = 16_156_309_504     # the tree the JAX package's init builds: its
                               # shared expert is num_shared_experts x
                               # shared_expert_dim = 5632 wide, where
                               # ArchConfig.param_count() (15,706,470,400)
                               # and the paper take 2816
DS_TRAIN_LAYERS = 2            # the dense first layer and one MoE layer
DS_SERVE_LAYERS = 5            # (d): the dense first layer and 4 MoE layers
DS_SERVE_PARAMS = 2_909_034_496  # (of 27 layers: the script has 1200 s)
DS_TRAIN_PARAMS = 1_102_587_904
DS_STEPS = 2
DS_BATCH, DS_SEQ = 2, 1024     # sequences of tokens a rank and step
MLA_SHAPE = (2, 1024, 16, 1, 576, 512)     # B, S, H, KV, Dk, Dv
MLA_KERNELS = ("flash_attention_mla", "flash_attention_mla_dq",
               "flash_attention_mla_dkv", "flash_attention_mla_dkv_reduce")
PHASE11_LEFT = 2 ** 26     # bytes phase 11 may leave allocated: a cuBLAS
                           # workspace of a stream it made, where torch
                           # cannot clear those
MOE_GRAD_TOL = 0.25   # the routed experts' and the router's gradients,
                      # kernels vs einsum attention: bf16 differences in the
                      # attention output move tokens across the top-6 and
                      # capacity edges, so a few tokens reach other experts
                      # on the two paths (each expert sees ~96 tokens of
                      # the 1024); every other leaf keeps GRAD_TOL


def mla_build_report(K):
    """Registers and spills (``ptxas -v``) of the CUDA-core forward, dq and
    dk/dv (fp32 at D 32, 64, 128 and on the MLA route's (96, 64) and (576,
    512)). Fails unless the three fp32 (576, 512) ones are in the log and
    no bf16/fp16 one is."""
    out = {}
    pat = r"(?:fwd|bwd_dq|bwd_dkv)_kernel"
    for name, r in _ptxas(K.build_log("flash_attention"), pat):
        kind = re.search(pat, name).group(0)
        ints = re.findall(r"Li(\d+)E", name)
        out[f"{kind}<{', '.join([_dtype_label(name)] + ints)}>"] = r
    print(f"flash CUDA-core kernels, ptxas ({len(out)} kernels): "
          + json.dumps(out))
    wide = [n for n in out if n.endswith("576, 512>")]
    if len(wide) != 3 or any("<fp32, " not in n for n in out):
        _fail(f"expected fp32 CUDA-core kernels alone, 3 of them at (576, "
              f"512), in the build log; found {sorted(out)}")
    return out


MLA_TC = re.compile(r"fwd_mla_hopper|bwd_dq_mla_hopper|bwd_dkv_mla_hopper|"
                    r"mla_dkv_reduce")
MLA_TC_KERNELS = 8   # forward, dq, dk/dv and the reduction x bf16, fp16 at
                     # (576, 512)


def _mla_label(mangled: str) -> str:
    """``fwd_mla_hopper<bf16, 576, 512>`` from a mangled kernel name."""
    ints = re.findall(r"Li(\d+)E", mangled)
    return (f"{MLA_TC.search(mangled).group(0)}<"
            f"{', '.join([_dtype_label(mangled)] + ints)}>")


def mla_tc_build_report(K):
    """The MLA route's bf16/fp16 kernels as built: registers and spills
    (``ptxas -v``) of the forward, dq, dk/dv and the reduction, and in
    their SASS the wgmma products (HGMMA), TMA loads (UTMALDG) and
    atomics. Fails unless the eight are built, the forward, dq and dk/dv
    hold HGMMA and UTMALDG, none holds an atomic and none spills."""
    regs = {_mla_label(n): r for n, r in _ptxas(
        K.build_log("flash_attention"), MLA_TC.pattern)}
    ops = {_mla_label(n): c for n, c in K.sass_ops(
        "flash_attention", MLA_TC.pattern).items()}
    print("MLA tensor-core kernels, ptxas: " + json.dumps(regs))
    print("MLA tensor-core kernels, SASS instructions: " + json.dumps(ops))
    products = [n for n in ops if "hopper" in n]
    if len(regs) != MLA_TC_KERNELS or sorted(ops) != sorted(regs) \
            or len(products) != 6 \
            or not all(ops[n]["HGMMA"] > 0 and ops[n]["UTMALDG"] > 0
                       for n in products) \
            or any(o["atomics"] for o in ops.values()):
        _fail(f"the {MLA_TC_KERNELS} MLA tensor-core kernels must be built, "
              f"the forward, dq and dk/dv with wgmma and TMA, none with "
              f"atomics")
    spills = {n: r for n, r in regs.items()
              if r["spill_stores"] + r["spill_loads"] > 0}
    if spills:
        _fail(f"the MLA tensor-core kernels spill: {spills}")
    return regs, ops


def _mla_inputs(torch, dtype, shape, seed, dev):
    B, S, H, KV, Dk, Dv = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dtype)
    return rn(B, S, H, Dk), rn(B, S, KV, Dk), rn(B, S, KV, Dv), \
        rn(B, S, H, Dv)


def _check_mla(torch, ref, fa, dtype, shape, window=0, seed=0, dev="cuda"):
    """The MLA-route forward (out, lse) and backward (dq, dk/dv) against
    their plain versions at one (B, S, H, KV, Dk, Dv) shape; returns the
    inputs, outputs and errors."""
    q, k, v, do = _mla_inputs(torch, dtype, shape, seed, dev)
    B, Dk = q.shape[0], q.shape[-1]
    qo = torch.zeros(B, dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(Dk)
    out, lse = fa.flash_attention(q, k, v, window=window, sm_scale=scale,
                                  return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, qo, window, scale, True)
    fp32 = dtype == torch.float32
    fwd_tol, bwd_tol = (1e-5, BWD_TOL_FP32) if fp32 else (FWD_TOL, BWD_TOL)
    err = (out.float() - want.float()).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=qo,
                                 window=window, sm_scale=scale)
    wantb = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, window,
                                        scale)
    names = ("dq", "dk", "dv")
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, got, wantb)}
    abs_errs = {n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(names, got, wantb)}
    print(f"MLA flash {shape} window {window} {str(dtype)[6:]}: out max |d| "
          f"{err}, lse {err_l}; backward max |d| / max |plain| "
          + json.dumps(errs))
    if not (err <= fwd_tol and err_l <= 1e-3):
        _fail(f"MLA flash forward {shape} {dtype}: {err}, lse {err_l}")
    if not all(e <= bwd_tol for e in errs.values()):
        _fail(f"MLA flash backward {shape} {dtype}: {errs} > {bwd_tol}")
    return dict(q=q, k=k, v=v, do=do, out=out, lse=lse, qo=qo, scale=scale,
                got=got, err=err, errs=errs, abs_errs=abs_errs)


def _sdpa_mla(torch, q, k, v, do, flush):
    """SDPA on the same q/k/v (causal, one KV head under all H): its
    forward time, the backward of its autograd graph (dq, dk, dv in one
    call) and the kernels it ran, by name. A yardstick; the port never
    calls it. Returns (fwd_ms, bwd_ms, kernels) with None where SDPA
    refused the shapes."""
    from torch.profiler import ProfilerActivity, profile
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    call = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True,
        scale=1 / math.sqrt(q.shape[-1]))
    try:
        call()
    except RuntimeError as e:
        print(f"SDPA at the MLA shape refused: {str(e)[:200]}")
        return None, None, None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = sorted({ev.name[:60] for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA})
    joined = " ".join(names).lower()
    backend = next((b for b, keys in (("flash", ("flash",)),
                                      ("efficient", ("fmha", "efficient")),
                                      ("cudnn", ("cudnn",)))
                    if any(k_ in joined for k_ in keys)), "math")
    names = [f"backend {backend}"] + names
    fwd_ms = _event_ms(call, flush=flush)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True,
        scale=1 / math.sqrt(q.shape[-1]))
    dot = do.transpose(1, 2)
    bwd_ms = _event_ms(lambda: torch.autograd.grad(o, leaves, dot,
                                                   retain_graph=True),
                       flush=flush)
    return fwd_ms, bwd_ms, names


def _mla_reduce_inputs(torch, fa, chunk, n_chunks, dev):
    """Random fp32 partials of the tensor-core dk/dv at MLA_SHAPE (causal,
    q_off 0) with every dead chunk NaN, their dk and dv views, and the
    live chunks of each key (B, S)."""
    B, S, H, KV, Dk, Dv = MLA_SHAPE
    rows = B * S * KV
    bq = fa.MLA_DKV_ROWS // (H // KV)
    nq = -(-S // bq)
    n_live = torch.tensor(
        [[-(-fa.mla_dkv_live(key // fa.MLA_DKV_KEYS, 0, 0, nq, bq)[1] // chunk)
          for key in range(S)] for _ in range(B)], device=dev)
    live = torch.arange(n_chunks, device=dev)[:, None, None] < n_live[None]
    g = torch.Generator(device=dev).manual_seed(36)
    part = torch.randn(n_chunks, rows * (Dk + Dv), generator=g, device=dev)
    part_k = part[:, :rows * Dk].view(n_chunks, B, S, KV, Dk)
    part_v = part[:, rows * Dk:].view(n_chunks, B, S, KV, Dv)
    for t in (part_k, part_v):
        t.masked_fill_(~live[..., None, None], float("nan"))
    return part.reshape(-1), part_k, part_v, n_live


def mla_kernel_phase(torch, ref, fa, flush, dev="cuda"):
    """(a) The MLA-route kernels against their plain versions at the MLA
    shape in bf16 and fp16 (two forward and two backward calls bitwise
    equal: no atomics), in fp32 at a smaller shape (the CUDA-core
    kernels), and at a ragged S
    with a window in bf16 and fp16; the tensor-core dk/dv's reduction
    alone, bit for bit, on partials whose dead chunks hold NaN; each
    timed from a CUDA graph with the L2 flushed, beside its bound, its
    plain version and SDPA. Returns the four kernel rows."""
    B, S, H, KV, Dk, Dv = MLA_SHAPE
    c = _check_mla(torch, ref, fa, torch.bfloat16, MLA_SHAPE, seed=31,
                   dev=dev)
    c16 = _check_mla(torch, ref, fa, torch.float16, MLA_SHAPE, seed=34,
                     dev=dev)
    _check_mla(torch, ref, fa, torch.float32, (1, 256, H, KV, Dk, Dv),
               seed=32, dev=dev)
    for dtype, seed in ((torch.bfloat16, 33), (torch.float16, 35)):
        _check_mla(torch, ref, fa, dtype, (2, 1000, H, KV, Dk, Dv),
                   window=300, seed=seed, dev=dev)
    for cc in (c, c16):
        fwd = fa.flash_attention(cc["q"], cc["k"], cc["v"], q_off=cc["qo"],
                                 sm_scale=cc["scale"], return_lse=True)
        again = fa.flash_attention_bwd(cc["q"], cc["k"], cc["v"], cc["out"],
                                       cc["lse"], cc["do"], q_off=cc["qo"],
                                       sm_scale=cc["scale"])
        same_f = torch.equal(fwd[0], cc["out"]) and torch.equal(fwd[1],
                                                                 cc["lse"])
        same = all(torch.equal(a, b) for a, b in zip(cc["got"], again))
        print(f"MLA {MLA_SHAPE} {str(cc['q'].dtype)[6:]}, two calls bitwise "
              f"equal: forward {same_f}, backward {same}")
        if not (same_f and same):
            _fail("two MLA forward or backward calls differ")
    del c16, fwd, again
    q, k, v, do, out, lse, qo, scale = (c[n] for n in (
        "q", "k", "v", "do", "out", "lse", "qo", "scale"))
    chunk, n_chunks = fa.mla_dkv_plan(B, S, S, H, KV, _sms(torch, dev))
    blocks = fa.mla_dkv_blocks(B, S, S, H, KV, [0] * B, 0, chunk)
    grid = n_chunks * 2 * -(-S // fa.MLA_DKV_KEYS) * KV * B
    print(f"MLA dk/dv plan at {MLA_SHAPE}: chunks of {chunk} q tiles of "
          f"{fa.MLA_DKV_ROWS // (H // KV)} queries, {n_chunks} a key tile; "
          f"{len(blocks)} of the {grid} blocks live; q tiles of the first "
          f"live blocks in launch order {[b_[-1] for b_ in blocks[:24]]}, "
          f"of the last {[b_[-1] for b_ in blocks[-8:]]}")
    part, part_k, part_v, n_live = _mla_reduce_inputs(torch, fa, chunk,
                                                      n_chunks, dev)
    red_kw = dict(B=B, Sq=S, Sk=S, H=H, KV=KV, Dk=Dk, Dv=Dv, window=0,
                  chunk=chunk, dtype=torch.bfloat16)
    red = fa.mla_dkv_reduce(part, qo, **red_kw)
    red_want = ref.mla_dkv_reduce_ref(part_k, part_v, n_live, torch.bfloat16)
    red_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(red, red_want))
    exact = all(torch.equal(a, b) for a, b in zip(red, red_want))
    print(f"MLA dk/dv reduction at {MLA_SHAPE} ({n_chunks} chunks, dead "
          f"ones NaN): equal to plain bit for bit: {exact}")
    if not exact:
        _fail(f"the MLA dk/dv reduction differs from plain by {red_err}")
    live_b = int(n_live.sum().item()) * KV * (Dk + Dv) * 4
    di = ref.flash_attention_di(out, do)
    kw = dict(q_off=qo, window=0, sm_scale=scale)
    sdpa_fwd, sdpa_bwd, sdpa_kernels = _sdpa_mla(torch, q, k, v, do, flush)
    print(f"SDPA at the MLA shape ran: {sdpa_kernels}")
    pairs = B * H * S * (S + 1) // 2           # live (row, key) pairs
    q_b, k_b, v_b, o_b = (B * S * H * Dk * 2, B * S * KV * Dk * 2,
                          B * S * KV * Dv * 2, B * S * H * Dv * 2)
    st_b = B * S * H * 4
    err = lambda outs: max(c["abs_errs"][o] for o in outs)  # noqa: E731
    rows = []
    for name, line, fn, plain, e, nbytes, flops, flop_s, outs, lib in (
            ("flash_attention_mla", 97,
             lambda: fa.flash_attention(q, k, v, q_off=qo, sm_scale=scale,
                                        return_lse=True),
             lambda: ref.flash_attention_ref(q, k, v, qo, 0, scale, True),
             c["err"], q_b + k_b + v_b + o_b + st_b, 2 * (Dk + Dv) * pairs,
             BF16_FLOP_S, None, sdpa_fwd),
            ("flash_attention_mla_dq", 179,
             lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dq_ref(q, k, v, lse, do, di, qo, 0,
                                                scale),
             err(("dq",)), 2 * q_b + k_b + v_b + o_b + 2 * st_b,
             2 * (2 * Dk + Dv) * pairs, BF16_FLOP_S, ("dq",), sdpa_bwd),
            # both launches: the chunks' partials, then their sum
            ("flash_attention_mla_dkv", 214,
             lambda: fa.flash_attention_dkv(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dkv_ref(q, k, v, lse, do, di, qo, 0,
                                                 scale),
             err(("dk", "dv")), q_b + 2 * k_b + 2 * v_b + o_b + 2 * st_b,
             4 * (Dk + Dv) * pairs, BF16_FLOP_S, ("dk", "dv"), sdpa_bwd),
            # the sum _dkv_kernel carries across q tiles in its scratch; no
            # PyTorch call skips the dead chunks
            ("flash_attention_mla_dkv_reduce", 214,
             lambda: fa.mla_dkv_reduce(part, qo, **red_kw),
             lambda: ref.mla_dkv_reduce_ref(part_k, part_v, n_live,
                                            torch.bfloat16),
             red_err, live_b + k_b + v_b, live_b // 4, FP32_FLOP_S, None,
             None)):
        row = dict(
            name=name, src="src/repro_torch/csrc/flash_attention.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}", err=e,
            ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
            plain_ms=_median_ms(plain, flush=flush), library_ms=lib,
            bound=_bound(nbytes, flops, flop_s))
        if outs is not None:
            row["rel_err"] = max(c["errs"][o] for o in outs)
        rows.append(row)
    keys = ("err", "ms", "plain_ms", "library_ms", "bound")
    print(f"MLA kernels at {MLA_SHAPE} bf16 (bound: bf16 tensor-core peak, "
          f"the reduction's fp32): " + json.dumps(
              {r["name"]: {k_: r[k_] for k_ in keys} for r in rows}))
    fwd = rows[0]
    print(f"MLA forward at {MLA_SHAPE} bf16: {fwd['ms']} ms, "
          f"{100 * fwd['bound'][0] / fwd['ms']:.1f} % of its bound "
          f"{fwd['bound'][0]} ms; SDPA's forward {sdpa_fwd} ms")
    bwd_ms = rows[1]["ms"] + rows[2]["ms"]
    print(f"MLA backward at {MLA_SHAPE} bf16: dq + dk/dv {bwd_ms} ms "
          f"(of the bound {rows[1]['bound'][0] + rows[2]['bound'][0]} ms); "
          f"SDPA's backward (dq, dk, dv) {sdpa_bwd} ms")
    return rows


def _ds_rank(rank, k, out_dir, device, smoke):
    """One rank of phase 11's DeepSeek-V2-Lite training run (spawned on
    ``device``: cuda:0, or the CPU with the smoke config to rehearse)."""
    import dataclasses
    import os

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import exchanger
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import rank_loader, write_rank_batches
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    cfg = ((get_smoke_config if smoke else get_config)(DS_ARCH)
           .with_overrides(num_layers=DS_TRAIN_LAYERS))
    base = build_model(cfg, dev)
    aux_seen = []          # each step's MoE aux loss, as the loss saw it

    def loss_fn(params, batch, gen=None):
        loss, metrics = base.loss_fn(params, batch, gen)
        aux_seen.append(metrics["aux"].detach())
        return loss, metrics
    model = dataclasses.replace(base, loss_fn=loss_fn)
    batch, seq = (2, 64) if smoke else (DS_BATCH, DS_SEQ)
    files = write_rank_batches(cfg, rank, k, batch, DS_STEPS,
                               os.path.join(out_dir, f"ds{rank}"), seq=seq)
    loader = rank_loader(cfg, files, dev, DS_STEPS, seed=rank)
    opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                       fused_kernel=fs.fused_sgd)
    plan = TrainPlan(exchanger="asa16", sharded_update=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = train(model, opt, warmup_cosine(0.01, 2, DS_STEPS), loader,
                       plan=plan, num_steps=DS_STEPS, log_every=1, seed=0,
                       print_fn=lambda *a: None)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    loader.stop()
    n_params = count_params(state["params"])
    rsplan = exchanger.make_rs_plan(state["params"], k)
    predicted = _predicted_launches(rsplan, len(leaves(state["params"])),
                                    "asa16", True, DS_STEPS, cuda, k)
    L = cfg.num_layers
    predicted.update({MLA_KERNELS[0]: (2 if cfg.remat else 1) * L * DS_STEPS,
                      MLA_KERNELS[1]: L * DS_STEPS,
                      MLA_KERNELS[2]: L * DS_STEPS,
                      # bf16 on the card: the tensor-core dk/dv's sum
                      MLA_KERNELS[3]: L * DS_STEPS if cuda else 0})
    predicted = _plus(predicted, _halves_launches(
        rsplan, "asa16", _tree_bytes(state["params"]), k))
    out = dict(rank=rank, params=n_params, steps=rep.steps,
               losses=rep.losses, aux=[float(a) for a in aux_seen],
               tokens_per_s=rep.steady_tokens_per_s,
               first_step_s=rep.first_step_time,
               phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
               staged_mb_per_step=rep.staged_bytes / 1e6,
               peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
               buckets=rsplan.num_buckets, launches=launches,
               predicted={n: c for n, c in predicted.items() if c})
    with open(os.path.join(out_dir, f"ds_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ds_train_phase(device="cuda:0", smoke=False):
    """(c) BSP training of DeepSeek-V2-Lite at full width, depth cut to
    DS_TRAIN_LAYERS, on k = 2 gloo ranks sharing the card: bf16 over fp32
    masters with remat, DS_BATCH x DS_SEQ tokens a rank, asa16 sharded,
    DS_STEPS steps. Returns the launches of rank 0."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_ds_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"ds_rank{r}.json").read_text())
                 for r in range(k)]
    for rk in ranks:
        if not smoke and rk["params"] != DS_TRAIN_PARAMS:
            _fail(f"{DS_ARCH} at {DS_TRAIN_LAYERS} layers has {rk['params']} "
                  f"parameters, not {DS_TRAIN_PARAMS:,}")
        vals = rk["losses"] + rk["aux"]
        if len(rk["losses"]) != DS_STEPS or not all(
                x is not None and math.isfinite(x) for x in vals) \
                or not all(a > 0 for a in rk["aux"]):
            _fail(f"{DS_ARCH} train rank {rk['rank']}: losses "
                  f"{rk['losses']}, aux {rk['aux']}")
        if rk["launches"] != rk["predicted"]:
            _fail(f"{DS_ARCH} train rank {rk['rank']}: launches "
                  f"{rk['launches']} != predicted {rk['predicted']}")
    m = ranks[0]
    print(f"{DS_ARCH} train ({DS_TRAIN_LAYERS} layers, k=2 gloo ranks on "
          f"{device}, asa16 sharded, {wall:.1f}s): " + json.dumps(
              {key: m[key] for key in (
                  "params", "tokens_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "buckets", "launches", "predicted",
                  "losses", "aux")}))
    print(f"{DS_ARCH} train peak memory per rank, GB: "
          + json.dumps([rk["peak_mem_gb"] for rk in ranks]))
    return dict(m["launches"])


def _release_card(torch) -> int:
    """Frees the cuBLAS workspaces of the streams the timers made and the
    allocator's cache; returns the bytes still allocated."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _decode_step_cost(torch, model, params, dev, paged=True):
    """One decode step of ``model`` (8 slots at SERVE_POSITIONS, pages of
    16, or contiguous 1 K lanes when not ``paged``): :func:`_step_cost`."""
    B, ps, NP = 8, 16, 64
    if paged:
        pool = model.init_paged_cache(B, ps, B * NP + 1)
        tables = (torch.arange(B * NP, dtype=torch.int32, device=dev) + 1
                  ).reshape(B, NP)
    else:
        pool, tables, ps = model.init_cache(B, NP * ps), None, 0
    pos = torch.tensor(SERVE_POSITIONS, device=dev)
    tok = {"tokens": torch.zeros(B, 1, dtype=torch.int64, device=dev)}
    cost = _step_cost(torch, lambda: model.decode_step(
        params, pool, tok, pos, seq_len=1024, block_tables=tables,
        page_size=ps), dev)
    del pool
    return cost


def _step_cost(torch, step, dev) -> dict:
    """Host ms for ``step()`` to return and wall ms to its synchronize
    (medians of 20, after 3 warm-up calls), and the operations it runs on
    the card and their summed device ms (torch.profiler)."""
    host, wall = [], []
    for i in range(23):
        _sync(torch, dev)
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        _sync(torch, dev)
        if i >= 3:
            host.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
    ops, busy = (_device_profile(torch, step) if dev.type == "cuda"
                 else (None, None))
    return dict(host_ms=sorted(host)[len(host) // 2],
                wall_ms=sorted(wall)[len(wall) // 2], device_ops=ops,
                device_busy_ms=busy)


def ds_engine_phase(torch, K, cfg, models, serve, dev):
    """(d) ``cfg`` (random weights in the compute dtype from a seeded
    generator on ``dev``) through the Engine with
    phase 4's traffic; then a short contiguous pass, one decode step's
    cost, and the drop-free check: a greedy request served alone gives
    the tokens it got beside 7 others. Returns the paged run's
    launches."""
    cfg = cfg.with_overrides(param_dtype=cfg.dtype)
    model = models.build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    n = models.count_params(params)
    print(f"{cfg.name}: init {n:,} params ({cfg.dtype}) in "
          f"{time.perf_counter() - t0:.1f}s")
    if dev.type == "cuda" and n != DS_SERVE_PARAMS:
        _fail(f"{cfg.name} at {cfg.num_layers} layers has {n} parameters, "
              f"not {DS_SERVE_PARAMS:,}")
    rng = __import__("numpy").random.RandomState(0)
    lens = rng.randint(32, 513, size=16)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n_)).tolist()
               for n_ in lens]
    shared = rng.randint(0, cfg.vocab_size, size=256).tolist()
    prompts[1] = shared + prompts[1][:64]
    prompts[9] = shared + prompts[9][:96]
    SP = serve.SamplingParams
    sps = [SP(temperature=0.0) if i % 2 == 0 else SP(temperature=0.8, seed=i)
           for i in range(16)]
    shape = dict(max_slots=8, max_seq=1024, prefill_chunk=32, page_size=16,
                 fused_sampling=True, device=dev)
    eng = serve.Engine(model, params, **shape)
    rids = [eng.submit(p, 32, sp) for p, sp in zip(prompts, sps)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if dev.type == "cuda" and launches.get("slot_gather_sample", 0) <= 0:
        _fail(f"slot_gather_sample was not launched serving {cfg.name}")
    for r in rids:
        out = results[int(r)]
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            _fail(f"{cfg.name} request {int(r)} returned {len(out)} tokens")
    st, al = eng.stats, eng.allocator
    if al.hits <= 0:
        _fail(f"{cfg.name}: the shared-prefix request took no prefix hit")
    stats = dict(
        params=n, requests=len(rids), wall_s=wall,
        prefill_tokens=st.prefill_tokens, prefill_tok_s=st.prefill_tok_s(),
        decode_steps=st.steps, decoded_tokens=st.decoded_tokens,
        decode_tok_s=st.decode_tok_s(), prefix_hit_pages=al.hits,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if dev.type == "cuda" else None),
        token_latency_ms={str(q): v * 1e3 for q, v in
                          st.token_latency_percentiles().items()},
        launches=launches)
    print(f"engine {cfg.name} " + json.dumps(stats))
    print(f"decode step ({cfg.name}, 8 slots, pages of 16): "
          + json.dumps(_decode_step_cost(torch, model, eng.params, dev)))
    # drop-free routing: request 0 (greedy, no shared prefix) alone
    solo = serve.Engine(model, eng.params, **shape)
    rid = solo.submit(prompts[0], 32, SP(temperature=0.0))
    alone = solo.run()[int(rid)]
    print(f"{cfg.name} request 0 alone equals its tokens beside 7 others: "
          f"{alone == results[int(rids[0])]}")
    if alone != results[int(rids[0])]:
        _fail(f"{cfg.name}: request 0 alone gave {alone[:8]}..., beside "
              f"others {results[int(rids[0])][:8]}...")
    del solo
    # the contiguous pool
    eng0 = serve.Engine(model, eng.params, **dict(shape, max_slots=4,
                                                  max_seq=256, page_size=0))
    rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
    res0 = eng0.run()
    if any(len(res0[int(r)]) != 8 for r in rids0):
        _fail(f"{cfg.name}: the contiguous engine run did not finish")
    print(f"{cfg.name} contiguous pass: 4 requests x 8 tokens done")
    return launches


def ds_phase(torch, ref, fa, K, models, serve, cfg_mod):
    """Phase 11: (a) the MLA kernels, (b) the gradient check, (c) k = 2
    training, (d) serving the full model. Frees the card back to the
    memory it started from. Returns (kernel rows, {path: launches})."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    start_mem = torch.cuda.memory_allocated()
    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = mla_kernel_phase(torch, ref, fa, l2.zero_)
    del l2
    torch.cuda.empty_cache()
    cfg = cfg_mod.get_config(DS_ARCH)
    lm_grad_check(torch, cfg.with_overrides(num_layers=DS_TRAIN_LAYERS),
                  models, dev)
    torch.cuda.empty_cache()
    by_path = {"deepseek_train": ds_train_phase()}
    by_path["serve_deepseek"] = ds_engine_phase(
        torch, K, cfg.with_overrides(num_layers=DS_SERVE_LAYERS), models,
        serve,
                                                dev)
    left = _release_card(torch) - start_mem
    print(f"phase 11 ({DS_ARCH}): {time.perf_counter() - t0:.1f}s, "
          f"{left} bytes left allocated")
    if left > PHASE11_LEFT:
        _fail(f"phase 11 left {left} bytes allocated")
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 12: the state-space and early-fusion decoders
# ---------------------------------------------------------------------------

MAMBA_ARCH, HYMBA_ARCH = "mamba2-1.3b", "hymba-1.5b"
CHAMELEON_ARCH = "chameleon-34b"
MAMBA_PARAMS = 1_446_714_368   # the reference's tree: 48 SSD blocks, the
                               # embedding and an untied head
HYMBA_PARAMS = 1_641_179_520   # 32 hybrid layers and 128 meta tokens
# (a)/(b) serve each at full width cut to these layers (the script has
# 1200 s): a quarter of mamba2's SSD blocks and of hymba's layers (0 and
# 7 global, the windowed ones between)
MAMBA_SERVE_LAYERS, MAMBA_SERVE_PARAMS = 12, 516_140_288
HYMBA_SERVE_LAYERS, HYMBA_SERVE_PARAMS = 8, 487_252_080
HYMBA_GRAD_LAYERS = 3          # layers 0 and 2 global, 1 on its 1024-key
                               # window, which 1024 tokens + 128 meta cut
HYMBA_GRAD_TOKENS = 1024
CHAMELEON_GRAD_LAYERS = 2
CHAMELEON_GRAD_TOKENS = 512    # after its 1024 image embeddings
HYMBA_MAX_SEQ = 2048           # room for the long requests
HYMBA_LONG = 2                 # requests of 1100-1500 prompt tokens: they
                               # carry the sliding layers past the window
# 8 slots over 2 K lanes, past the 1024-key window (the decode rows)
HYMBA_POSITIONS = (100, 700, 1023, 1024, 1100, 1400, 1700, 2047)
HYMBA_CHUNK_OFF = 1280         # the forward row's prefill chunk start
CHUNK_TOL = 1e-3      # chunked vs single-call prefill on the card in fp32,
                      # max |d| over max |x| of the last logits and each SSM
                      # leaf: bitwise on the CPU, but cuBLAS picks its
                      # kernels by shape (M 128 vs the whole prompt), so sums
                      # run in another order. In bf16 (printed, not held)
                      # the rounding apart carries through depth to the bf16
                      # policy's own noise: 0.0565 of the state's max at
                      # mamba2's 48 blocks on an H100 (its bf16 logits lie
                      # 0.23 from fp32 of |x| 4.75), so bf16 cannot tell a
                      # carry fault from rounding


def _phase12_requests(cfg, n_long=0):
    """Phase 4's traffic (16 prompts of 32-512 tokens, half greedy, the
    rest at temperature 0.8), then ``n_long`` greedy prompts of 1100-1500
    tokens."""
    import numpy as np
    rng = np.random.RandomState(0)
    lens = list(rng.randint(32, 513, size=16)) + list(
        rng.randint(1100, 1501, size=n_long))
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    sps = [(0.0, 0) if i % 2 == 0 or i >= 16 else (0.8, i)
           for i in range(len(prompts))]
    return prompts, sps


def ssm_engine_phase(torch, K, cfg, models, serve, dev, want_params,
                     max_seq, n_long=0):
    """(a)/(b) ``cfg`` (random weights in the compute dtype from a
    seeded generator) through the Engine: 8 slots, chunks rounded up to
    the SSD chunk, pages of 16 where the model has attention (the SSM
    lanes one a slot, no prefix cache), fused sampling. Prints the rates,
    latencies and launches, one decode step's host ms and device
    operations; request 8 (greedy, in a lane that held one of requests
    0-7) must get what it gets through a fresh engine. With attention, a
    short contiguous pass reaches ``flash_decode``. Returns (launches,
    model, the engine's parameters)."""
    cfg = cfg.with_overrides(param_dtype=cfg.dtype)
    model = models.build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    n = models.count_params(params)
    print(f"{cfg.name}: init {n:,} params ({cfg.dtype}) in "
          f"{time.perf_counter() - t0:.1f}s")
    if dev.type == "cuda" and n != want_params:
        _fail(f"{cfg.name} has {n} parameters, not {want_params:,}")
    prompts, sps = _phase12_requests(cfg, n_long)
    SP = serve.SamplingParams
    shape = dict(max_slots=8, max_seq=max_seq, prefill_chunk=32,
                 page_size=16, fused_sampling=True, device=dev)
    eng = serve.Engine(model, params, **shape)
    del params
    paged = cfg.attention is not None
    Q = cfg.ssm.chunk
    if (eng.paged, eng.prefill_chunk) != (paged, -(-32 // Q) * Q) or (
            eng.allocator is not None and eng.allocator.prefix_cache):
        _fail(f"{cfg.name}: engine paged {eng.paged}, chunk "
              f"{eng.prefill_chunk}, prefix cache on")
    rids = [eng.submit(p, 32, SP(temperature=t, seed=sd))
            for p, (t, sd) in zip(prompts, sps)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    need = (("flash_attention", "flash_decode_paged", "flash_decode_combine")
            if paged else ()) + ("slot_gather_sample",)
    for name in need:
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was not launched serving {cfg.name}")
    if not paged and set(launches) != {"slot_gather_sample"}:
        _fail(f"{cfg.name} has no attention but launched {launches}")
    # the sampler's launches by shape: the decode's (8, 1, V) and the
    # prefill tail's (1, chunk, V), nothing else
    shapes = {s_: c for (n_, s_), c in K.LAUNCH_SHAPES.items()
              if n_ == "slot_gather_sample"}
    V = cfg.vocab_size
    if (set(shapes) - {(8, 1, V), (1, eng.prefill_chunk, V)}
            or sum(shapes.values()) != launches["slot_gather_sample"]):
        _fail(f"{cfg.name}: the sampler ran at {shapes}, "
              f"{launches['slot_gather_sample']} launches in all")
    launches.update({_shape_key("slot_gather_sample", s_): c
                     for s_, c in shapes.items()})
    for r in rids:
        out = results[int(r)]
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            _fail(f"{cfg.name} request {int(r)} returned {len(out)} tokens")
    st = eng.stats
    last = max(len(p) for p in prompts) + 31     # the last position decoded
    stats = dict(
        params=n, requests=len(rids), paged=eng.paged,
        prefill_chunk=eng.prefill_chunk, wall_s=wall,
        prefill_tokens=st.prefill_tokens, prefill_tok_s=st.prefill_tok_s(),
        decode_steps=st.steps, decoded_tokens=st.decoded_tokens,
        decode_tok_s=st.decode_tok_s(), last_position=last,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if dev.type == "cuda" else None),
        token_latency_ms={str(q): v * 1e3 for q, v in
                          st.token_latency_percentiles().items()},
        launches=launches)
    if paged:
        w = cfg.attention.sliding_window
        stats["requests_past_window"] = sum(len(p) + 31 >= w
                                            for p in prompts)
        if last < w + eng.prefill_chunk:
            _fail(f"{cfg.name}: no request passed the {w}-key window")
    print(f"engine {cfg.name} " + json.dumps(stats))
    print(f"decode step ({cfg.name}, 8 slots, "
          f"{'pages of 16' if paged else 'contiguous 1 K lanes'}): "
          + json.dumps(_decode_step_cost(torch, model, eng.params, dev,
                                         paged=paged)))
    # request 8 was admitted into a lane that one of requests 0-7 held
    solo = serve.Engine(model, eng.params, **shape)
    rid = solo.submit(prompts[8], 32, SP(temperature=0.0))
    alone = solo.run()[int(rid)]
    same = alone == results[int(rids[8])]
    print(f"{cfg.name} request 8 through a reused slot equals a fresh "
          f"engine's: {same}")
    if not same:
        _fail(f"{cfg.name}: request 8 in a fresh engine gave {alone[:8]}..., "
              f"through a reused slot {results[int(rids[8])][:8]}...")
    del solo
    if paged:
        eng0 = serve.Engine(model, eng.params, **dict(
            shape, max_slots=4, max_seq=256, page_size=0))
        rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
        K.reset_launches()
        res0 = eng0.run()
        _sync(torch, dev)
        launches["flash_decode"] = K.LAUNCHES.get("flash_decode", 0)
        launches["flash_decode_combine"] += K.LAUNCHES.get(
            "flash_decode_combine", 0)
        if launches["flash_decode"] <= 0:
            _fail(f"flash_decode was not launched by {cfg.name}'s "
                  f"contiguous engine run")
        if any(len(res0[int(r)]) != 8 for r in rids0):
            _fail(f"{cfg.name}: the contiguous engine run did not finish")
        print(f"{cfg.name} contiguous pass: 4 requests x 8 tokens, launches "
              + json.dumps(dict(K.LAUNCHES)))
        del eng0
    return launches, model, eng.params


def check_chunked_prefill(torch, cfg, models, params, prompt, dev):
    """(c) ``prompt`` prefilled in chunks of the SSD chunk against one
    call on a paged pool: the last logits and every SSM leaf, in fp32 held
    to CHUNK_TOL, in the served dtype printed."""
    from repro_torch.tree import flatten, unflatten
    leaves, treedef = flatten(params)
    fp32 = (cfg.with_overrides(dtype="float32"),
            unflatten(treedef, [t.float() for t in leaves]))
    del leaves
    Q, ps = cfg.ssm.chunk, 16
    prompt = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    S0 = prompt.shape[1]
    NP = -(-S0 // ps)
    tables = torch.arange(1, NP + 1, dtype=torch.int32, device=dev)[None]
    read = {}
    for label, (c, pr) in (("fp32", fp32), (cfg.dtype, (cfg, params))):
        m = models.build_model(c, dev)
        got = []
        for C in (Q, S0):
            pool = m.init_paged_cache(1, ps, NP + 1)
            for ch in range(0, S0, C):
                lg, pool = m.chunk_prefill(pr, pool, prompt[:, ch:ch + C], ch,
                                           C, seq_len=NP * ps,
                                           block_tables=tables, page_size=ps)
            got.append([lg[:, -1].float()] + [
                seg["ssm"][n].float() for seg in pool if "ssm" in seg
                for n in ("conv", "state")])
            del pool
        diffs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                 for a, b in zip(*got)]
        read[label] = dict(bitwise=all(torch.equal(a, b) for a, b in
                                       zip(*got)),
                           last_logits=diffs[0], ssm_leaves=max(diffs[1:]))
        if label == "fp32":
            held = diffs
    del fp32
    print(f"chunked ({S0 // Q} x {Q}) vs one-call prefill ({cfg.name}, "
          f"{S0} tokens), max |d| / max |x| (fp32 held to {CHUNK_TOL}): "
          + json.dumps(read))
    if not all(math.isfinite(d) and d <= CHUNK_TOL for d in held):
        _fail(f"{cfg.name}: chunked prefill differs from one call by "
              f"{max(held)} > {CHUNK_TOL} in fp32")


def _window_flash(torch, ref, fa, g, flush, dev="cuda"):
    """The forward at Hymba's prefill chunk (128 queries at HYMBA_CHUNK_OFF
    over a 2 K lane, 25 heads over 5, D 64, bf16) on a sliding layer's
    1024-key window, held to its plain version (output and lse) and timed
    beside SDPA and its bound."""
    import torch.nn.functional as F
    H, KV, D, Sq, Sk, W = 25, 5, 64, 128, HYMBA_MAX_SEQ, 1024
    dtype = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    q, k, v = rn(1, Sq, H, D), rn(1, Sk, KV, D), rn(1, Sk, KV, D)
    q_off = torch.tensor([HYMBA_CHUNK_OFF], dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(D)
    got, lse = fa.flash_attention(q, k, v, q_off=q_off, window=W,
                                  return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, W, scale, True)
    err = (got.float() - want.float()).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    if not (err <= FWD_TOL and err_l <= 1e-3):
        _fail(f"flash_attention at Hymba's chunk (window {W}) vs plain: max "
              f"err {err}, lse {err_l}")
    row = dict(name="flash_attention", src="src/repro_torch/csrc/"
               "flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:97", err=err,
               lse_err=err_l, shape=f"q (1, {Sq}, {H}, {D}) at {int(q_off)} "
               f"over {Sk} keys / {KV} heads, window {W}, bf16")
    if flush is None:
        return row
    qpos = torch.arange(Sq, device=dev) + int(q_off)
    kpos = torch.arange(Sk, device=dev)[None]
    mask = (kpos <= qpos[:, None]) & (qpos[:, None] - kpos < W)
    keys = int(mask.sum())                        # live (row, key) pairs
    span = int(q_off) + Sq - max(int(q_off) - W + 1, 0)   # keys read
    fn = lambda: fa.flash_attention(q, k, v, q_off=q_off, window=W)
    row.update(
        ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
        plain_ms=_median_ms(
            lambda: ref.flash_attention_ref(q, k, v, q_off, W, scale),
            flush=flush),
        library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), flush=flush),
        bound=_bound(2 * q.numel() * 2 + 2 * span * KV * D * 2 + 4,
                     4 * D * H * keys))
    return row


def phase12_kernel_rows(torch, ref, fa, flush, dev="cuda"):
    """(e) The flash kernels at Hymba's serve shapes, each held to its
    plain version: the split-KV decode, contiguous and paged, and its
    combine at Hymba's decode (8 slots at HYMBA_POSITIONS over 2 K lanes,
    25 heads over 5, D 64, window 1024, bf16); the forward at Hymba's
    windowed prefill chunk. Each row carries its shape and the path that
    runs it. (The sampler's rows at the new vocabularies come from phase
    3.) Then the flash forward and backward at the gradient checks'
    shapes, held to their plain versions and two backward calls bitwise
    equal: Hymba's 128 meta + 1024 tokens (25 heads over 5, D 64) on the
    sliding layer's 1024-key window and on every key, Chameleon's 1024
    image embeddings + 512 tokens (64 heads over 8, D 128)."""
    hy = (1, HYMBA_GRAD_TOKENS + 128, 25, 5, 64)
    cham = (1, CHAMELEON_GRAD_TOKENS + 1024, 64, 8, 128)
    for i, (shape, window) in enumerate(((hy, 1024), (hy, 0), (cham, 0))):
        _check_bwd(torch, ref, fa, torch.bfloat16, shape, BWD_TOL,
                   fwd_tol=FWD_TOL, seed=25 + i, dev=dev, window=window,
                   twice=True)
    g = torch.Generator(device=dev).manual_seed(1512)
    hymba = ("serve_" + HYMBA_ARCH,)
    rows = []
    dec = _serve_decode(torch, ref, fa, g, 25, 5, 64, torch.bfloat16, flush,
                        HYMBA_POSITIONS, HYMBA_MAX_SEQ, dev, window=1024)
    for r in dec.values():
        r.update(shape=f"8 slots at {list(HYMBA_POSITIONS)} over "
                 f"{HYMBA_MAX_SEQ} keys, 25/5 heads, D 64, window 1024, "
                 f"bf16, pages of 16", paths=hymba)
        rows.append(r)
    r = _window_flash(torch, ref, fa, g, flush, dev)
    r["paths"] = hymba
    rows.append(r)
    print("serve kernels at Hymba's shapes, equal to plain within "
          "tolerance: " + json.dumps(
              [{k_: r.get(k_) for k_ in ("name", "shape", "err", "ms",
                                         "plain_ms", "library_ms", "bound")}
               for r in rows]))
    return rows


def ssm_phase(torch, ref, fa, K, models, serve, cfg_mod):
    """Phase 12: (e) the kernels at the new shapes, (a) mamba2-1.3b and
    (b) hymba-1.5b served at full width, depth cut, each with (c) its
    teacher-forced and
    chunked-prefill checks, (d) the gradient checks of hymba-1.5b (3
    layers) and chameleon-34b (2 layers) at full width. Frees the card
    back to the memory it started from. Returns (kernel rows, {path:
    launches})."""
    import numpy as np
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    start_mem = torch.cuda.memory_allocated()
    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = phase12_kernel_rows(torch, ref, fa, l2.zero_)
    del l2
    torch.cuda.empty_cache()
    rng = np.random.RandomState(12)
    by_path = {}
    for arch, want, max_seq, n_long, lens in (
            (MAMBA_ARCH, MAMBA_SERVE_PARAMS, 1024, 0, (256, 256)),
            (HYMBA_ARCH, HYMBA_SERVE_PARAMS, HYMBA_MAX_SEQ, HYMBA_LONG,
             (256, 1152))):
        cfg = cfg_mod.get_config(arch).with_overrides(num_layers={
            MAMBA_ARCH: MAMBA_SERVE_LAYERS,
            HYMBA_ARCH: HYMBA_SERVE_LAYERS}[arch])
        launches, model, params = ssm_engine_phase(
            torch, K, cfg, models, serve, dev, want, max_seq, n_long)
        by_path["serve_" + arch] = launches
        prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in lens]
        check_flash_vs_ref(torch, cfg, models, params, prompts, dev,
                           chunk=cfg.ssm.chunk)
        check_chunked_prefill(torch, cfg, models, params, prompts[0], dev)
        del model, params
        torch.cuda.empty_cache()
    hymba = cfg_mod.get_config(HYMBA_ARCH)
    by_path["grad_" + HYMBA_ARCH] = lm_grad_check(
        torch, hymba.with_overrides(num_layers=HYMBA_GRAD_LAYERS), models,
        dev, shape=(1, HYMBA_GRAD_TOKENS))
    torch.cuda.empty_cache()
    cham = cfg_mod.get_config(CHAMELEON_ARCH)
    by_path["grad_" + CHAMELEON_ARCH] = lm_grad_check(
        torch, cham.with_overrides(num_layers=CHAMELEON_GRAD_LAYERS), models,
        dev, shape=(1, CHAMELEON_GRAD_TOKENS),
        image_tokens=cham.num_image_tokens)
    left = _release_card(torch) - start_mem
    print(f"phase 12 ({MAMBA_ARCH}, {HYMBA_ARCH}, {CHAMELEON_ARCH}): "
          f"{time.perf_counter() - t0:.1f}s, {left} bytes left allocated")
    if left > PHASE11_LEFT:
        _fail(f"phase 12 left {left} bytes allocated")
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 13: sharded (GSPMD/FSDP) training
# ---------------------------------------------------------------------------

GSPMD_STEPS = 2       # steps of each llama3.2-1b run of phase 13(a)
GSPMD_LM_LAYERS = 2   # (a)'s depth cut, full width (the script has 1200 s)
GSPMD_LM_PARAMS = 384_313_344
GSPMD_REL = 0.05      # max |dp| between two bf16 trajectories of (a) that
                      # compute the same mean gradient in another shape or
                      # order (k=2 halves vs k=1 on the batch; zero1's
                      # all-to-all vs ar's all-reduce; gspmd vs BSP's fused
                      # RS tail), over the largest parameter movement of the
                      # run's steps: bf16 gradients agree to a few 2^-8 of |g|
                      # (the CPU rehearsal at the smoke config read 0.013)
GSPMD_LOSS_RTOL = 1e-3  # their losses (the global batch's mean, bf16)
QWEN_ARCH = "qwen1.5-4b"
QWEN_PARAMS = 3_950_369_280
QWEN_GSPMD_LAYERS = 2    # (b)'s depth cut, full width (the script has
QWEN_GSPMD_PARAMS = 936_537_600     # 1200 s)
QWEN_GSPMD_STEPS = 2
QWEN_TOKENS = 1024    # 1 x 1024 tokens a rank


def _gspmd_predicted(cfg, n_leaves: int, steps: int, mode: str) -> dict:
    """A gspmd run's launches on one rank: the flash forward (twice a layer
    under remat), dq and dk/dv a layer; ``chunk_sum`` once a gather
    (the top-level leaves, an untied head, each layer) in zero1's
    reduce-scatter; ``fused_sgd`` on every shard leaf."""
    L = cfg.num_layers
    out = {"flash_attention": (2 if cfg.remat else 1) * L * steps,
           "flash_attention_dq": L * steps,
           "flash_attention_dkv": L * steps,
           "fused_sgd": n_leaves * steps}
    if mode == "zero1":
        out["chunk_sum"] = (L + (1 if cfg.tie_embeddings else 2)) * steps
    return out


def _gspmd_packs(specs) -> list:
    """Elements a rank sends into each gather of a decoder's gspmd step
    (the top-level leaves, an untied head, then each layer): shard
    elements plus whole leaves."""
    from repro_torch.tree import leaves
    n = lambda tree: sum(math.prod(s.shard_shape) for s in leaves(tree))  # noqa: E731
    top = {k_: v for k_, v in specs.items() if k_ not in ("layers", "head")}
    head = [n(specs["head"])] if "head" in specs else []
    return [n(top)] + head + [n(lp) for lp in specs["layers"]]


def _global_batch(torch, cfg, k, batch, seq, step, dev):
    """Global batch ``step`` of the k rank shares that write_rank_batches
    gives the ranks, concatenated in rank order (on ``dev``)."""
    import numpy as np

    from repro_torch.launch.train import RankShare, rank_source
    parts = [RankShare(rank_source(cfg, seq), r, k).batch(batch, step)
             for r in range(k)]
    return {n: torch.from_numpy(np.concatenate([p[n] for p in parts])).to(dev)
            for n in parts[0]}


def _gspmd_rank(rank, k, out_dir, device, smoke):
    """One of the 2 ranks of phase 13 (a spawned process on ``device``:
    cuda:0, or the CPU with smoke configs to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import exchanger
    from repro_torch.core.gspmd import (abstract_params, fsdp_shardings,
                                        shard_leaf)
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant, sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan, build_engine
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()        # the fp32 k=2 vs k=1 check wants full fp32 matmuls
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    quiet = lambda *a: None  # noqa: E731
    opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                       fused_kernel=fs.fused_sgd)
    get = get_smoke_config if smoke else get_config
    solo = dist.new_group([0])
    out = {"rank": rank}

    def free():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def run(model, plan, batches, steps, lr, group=None):
        """One training run through the loop: (state, its report)."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        state, rep = train(model, opt, lr, batches, plan=plan, group=group,
                           num_steps=steps, log_every=steps, seed=0,
                           print_fn=quiet)
        if cuda:
            torch.cuda.synchronize()
        return state, _run_report(torch, rep, dict(K.LAUNCHES), None, cuda)

    # --- (a) llama3.2-1b at full width cut to GSPMD_LM_LAYERS: gspmd zero1
    # and ar, BSP asa with the sharded update, GSPMD_STEPS each on the LM
    # phase's batches
    cfg = get("llama3.2-1b")
    if not smoke:
        cfg = cfg.with_overrides(num_layers=GSPMD_LM_LAYERS)
    model = build_model(cfg, dev)
    specs = fsdp_shardings(abstract_params(model), k)
    spec_ls = leaves(specs)
    n_params = count_params(abstract_params(model))
    if not smoke and n_params != GSPMD_LM_PARAMS:
        _fail(f"llama3.2-1b at {GSPMD_LM_LAYERS} layers has {n_params} "
              f"parameters, not {GSPMD_LM_PARAMS:,}")
    batch, seq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    files = write_rank_batches(cfg, rank, k, batch, GSPMD_STEPS,
                               os.path.join(out_dir, f"g{rank}"), seq=seq)
    lr = warmup_cosine(0.01, 2, GSPMD_STEPS)
    dmax = lambda a, b: max((x.float() - y.float()).abs().max().item()  # noqa: E731
                            for x, y in zip(a, b))
    # this rank's shards of the loop's initial parameters (its seed 0)
    init = [shard_leaf(p, s, rank).cpu() for p, s in zip(leaves(model.init(
        torch.Generator(device=dev).manual_seed(0))), spec_ls)]
    free()
    finals, runs = {}, {}
    for name, plan in (("zero1", TrainPlan(algo="gspmd", mode="zero1")),
                       ("ar", TrainPlan(algo="gspmd", mode="ar")),
                       ("bsp", TrainPlan(exchanger="asa",
                                         sharded_update=True))):
        loader = rank_loader(cfg, files, dev, GSPMD_STEPS, seed=rank)
        state, rr = run(model, plan, loader, GSPMD_STEPS, lr)
        loader.stop()
        ps = leaves(state["params"])
        if name == "bsp":       # this rank's shard of the full parameters
            rsplan = exchanger.make_rs_plan(state["params"], k)
            nb, ns = rsplan.num_buckets, len(rsplan.small)
            # fp32 wire both ways: the fused tail on the card, else the sum
            # and the flat update; no cast
            rr["predicted"] = {n: c * GSPMD_STEPS for n, c in (
                {"fused_rs_update": nb, "fused_sgd": ns} if cuda else
                {"chunk_sum": nb, "fused_sgd": nb + ns}).items() if c}
            rr["predicted"].update({
                n: c for n, c in _gspmd_predicted(
                    cfg, 0, GSPMD_STEPS, "ar").items()
                if n.startswith("flash")})
            rr["predicted"] = _plus(rr["predicted"], _halves_launches(
                rsplan, "asa", _tree_bytes(state["params"]), k))
            ps = [shard_leaf(p, s, rank) for p, s in zip(ps, spec_ls)]
        else:
            rr["predicted"] = _gspmd_predicted(cfg, len(ps), GSPMD_STEPS,
                                               name)
            rr["shard_numel"] = sum(p.numel() for p in ps)
        finals[name] = [p.detach().cpu() for p in ps]
        runs[name] = rr
        del state, ps
        free()
    out["runs"] = runs
    out["params"] = n_params
    out["packs"] = _gspmd_packs(specs)
    out["max_abs_step"] = dmax(finals["zero1"], init)
    out["zero1_vs_ar"] = dict(max_abs_dp=dmax(finals["zero1"], finals["ar"]),
                              bitwise=all(torch.equal(x, y) for x, y in zip(
                                  finals["zero1"], finals["ar"])))
    out["zero1_vs_bsp_max_abs_dp"] = dmax(finals["zero1"], finals["bsp"])
    # gspmd at k=1 on the global batches (rank 0, a group of one; rank 1
    # has freed the card and waits)
    dist.barrier()
    if rank == 0:
        gb = [_global_batch(torch, cfg, k, batch, seq, j, dev)
              for j in range(GSPMD_STEPS)]
        state, rr = run(model, TrainPlan(algo="gspmd"), gb, GSPMD_STEPS, lr,
                        group=solo)
        one = [shard_leaf(p, s, 0).cpu()
               for p, s in zip(leaves(state["params"]), spec_ls)]
        out["k1"] = dict(losses=rr["losses"], peak_mem_gb=rr["peak_mem_gb"],
                         max_abs_dp={n: dmax(finals[n], one)
                                     for n in ("zero1", "ar")})
        del state, gb
    del finals, init, model
    free()
    dist.barrier()

    # --- the fp32 k=2 = k=1 check of the LM phase, at the smoke config
    # with the attention through the kernels, for both modes
    scfg = get_smoke_config("llama3.2-1b").with_overrides(dtype="float32")
    smodel = build_model(scfg, dev)
    full = {n: torch.from_numpy(v).to(dev) for n, v in
            LMTokenSource(scfg.vocab_size, 64).batch(4, 777).items()}
    half = {n: v[rank * 2:(rank + 1) * 2] for n, v in full.items()}
    out["k2_vs_k1"] = {}
    for mode in ("zero1", "ar"):
        plan = TrainPlan(algo="gspmd", mode=mode)
        eng = build_engine(plan, smodel, opt, constant(0.01))
        two, _ = eng.step(eng.init_state(torch.Generator(device=dev)
                                         .manual_seed(7)), half)
        mine = leaves(two["params"])
        if rank == 0:
            eng1 = build_engine(plan, smodel, opt, constant(0.01), solo)
            one, _ = eng1.step(eng1.init_state(torch.Generator(device=dev)
                                               .manual_seed(7)), full)
            sspecs = leaves(eng.specs)
            out["k2_vs_k1"][mode] = dmax(
                mine, [shard_leaf(p, s, 0) for p, s in zip(
                    leaves(one["params"]), sspecs)])
    del smodel
    free()
    dist.barrier()

    # --- (b) qwen1.5-4b at full width and depth, gspmd zero1, 1 x 1024
    # tokens a rank, 2 steps
    qcfg = get(QWEN_ARCH)
    if not smoke:
        qcfg = qcfg.with_overrides(num_layers=QWEN_GSPMD_LAYERS)
    qmodel = build_model(qcfg, dev)
    nq = count_params(abstract_params(qmodel))
    if not smoke and nq != QWEN_GSPMD_PARAMS:
        _fail(f"{QWEN_ARCH} at {QWEN_GSPMD_LAYERS} layers has {nq} "
              f"parameters, not {QWEN_GSPMD_PARAMS:,}")
    qseq = 64 if smoke else QWEN_TOKENS
    qfiles = write_rank_batches(qcfg, rank, k, 1, QWEN_GSPMD_STEPS,
                                os.path.join(out_dir, f"q{rank}"), seq=qseq)
    if rank == 0:
        # the first step's loss at k=1: the same parameters (the loop's
        # init, seed 0) forward on the global batch, bf16, no gradient
        with torch.no_grad():
            p0 = qmodel.init(torch.Generator(device=dev).manual_seed(0))
            loss1, _ = qmodel.loss_fn(p0, _global_batch(
                torch, qcfg, k, 1, qseq, 0, dev))
            out["qwen_k1_loss"] = float(loss1)
            del p0, loss1
        free()
    dist.barrier()
    loader = rank_loader(qcfg, qfiles, dev, QWEN_GSPMD_STEPS, seed=rank)
    state, rr = run(qmodel, TrainPlan(algo="gspmd"), loader,
                    QWEN_GSPMD_STEPS, warmup_cosine(0.01, 2,
                                                    QWEN_GSPMD_STEPS))
    loader.stop()
    qspecs = fsdp_shardings(abstract_params(qmodel), k)
    rr["predicted"] = _gspmd_predicted(qcfg, len(leaves(state["params"])),
                                       QWEN_GSPMD_STEPS, "zero1")
    rr["shard_numel"] = sum(p.numel() for p in leaves(state["params"]))
    out["qwen"] = dict(rr, params=nq, layers=qcfg.num_layers,
                       packs=_gspmd_packs(qspecs))
    del state
    free()
    dist.barrier()
    with open(os.path.join(out_dir, f"gspmd{rank}.json"), "w") as f:
        json.dump(out, f)


def gspmd_phase(device="cuda:0", smoke=False):
    """Phase 13: prints the reckoning of (b), spawns the 2 ranks, and checks
    and prints what they report. Returns ({path: rank 0's launches},
    the shapes of (c): {"llama"/"qwen": (receive buffer, largest shard,
    distinct shard shapes)})."""
    import tempfile

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.gspmd import abstract_params, fsdp_shardings
    from repro_torch.launch.train import run_ranks
    from repro_torch.models import build_model, count_params
    from repro_torch.tree import leaves
    k = 2
    get = get_smoke_config if smoke else get_config
    specs = {}
    for key, arch in (("llama", "llama3.2-1b"), ("qwen", QWEN_ARCH)):
        cfg = get(arch)
        if not smoke:
            cfg = cfg.with_overrides(num_layers={
                "llama": GSPMD_LM_LAYERS, "qwen": QWEN_GSPMD_LAYERS}[key])
        specs[key] = fsdp_shardings(abstract_params(build_model(cfg, "meta")),
                                    k)
    # (b)'s reckoning, before the run, for the whole model: replicated BSP
    # holds fp32 parameters, gradients and momentum whole on each rank;
    # FSDP holds 1/k of the parameters and momentum at rest, and 1/k of
    # the gradients after the backward
    whole = fsdp_shardings(abstract_params(build_model(get(QWEN_ARCH),
                                                       "meta")), k)
    nq = sum(math.prod(s.shape) for s in leaves(whole))
    total = (torch.cuda.get_device_properties(0).total_memory
             if torch.cuda.is_available() else float("nan"))
    bsp_rank = 3 * nq * 4
    fsdp_rank = 3 * sum(math.prod(s.shard_shape)
                        for s in leaves(whole)) * 4
    print(f"phase 13(b) reckoning, {QWEN_ARCH} ({nq:,} parameters, fp32 "
          f"masters) on {k} ranks: replicated BSP needs parameters + "
          f"gradients + momentum = {bsp_rank / 1e9:.1f} GB a rank, "
          f"{k * bsp_rank / 1e9:.1f} GB for {k}, against the card's "
          f"{total / 1e9:.1f} GB; gspmd zero1 holds {fsdp_rank / 1e9:.1f} GB "
          f"a rank of shards (parameters, momentum, gradients) before "
          f"activations, one layer's gathered parameters and the gathered "
          f"embeddings ({k * fsdp_rank / 1e9:.1f} GB for {k}); the run cuts "
          f"it to {QWEN_GSPMD_LAYERS} layers at full width (phase 16 trains "
          f"gspmd on larger trees)")
    if torch.cuda.is_available():
        free_b, total_b = torch.cuda.mem_get_info()
        print(f"phase 13: the card's free memory before the ranks start "
              f"{free_b / 1e9:.2f} of {total_b / 1e9:.2f} GB (this process "
              f"reserves {torch.cuda.memory_reserved() / 1e9:.2f} GB)")
    # the BSP run of (a) peaks at ~32 GB a rank with two ranks on one
    # card: growable segments keep each rank's cache from splitting
    # (with fixed segments a rank once held 14 GB it could not reuse for
    # a 2 GB block)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            run_ranks(_gspmd_rank, k, (td, device, smoke), backend="gloo")
            wall = time.perf_counter() - t0
            ranks = [json.loads(Path(td, f"gspmd{r}.json").read_text())
                     for r in range(k)]
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    r0 = ranks[0]
    print(f"gspmd phase: {k} gloo ranks on {device}, {wall:.1f}s")
    show = ("tokens_per_s", "first_step_s", "phase_ms", "staged_mb_per_step",
            "stage_ms_per_step", "wire_ms_per_step", "launches", "predicted",
            "losses")
    for label, steps, get_run in (
            ("zero1", GSPMD_STEPS, lambda rk: rk["runs"]["zero1"]),
            ("ar", GSPMD_STEPS, lambda rk: rk["runs"]["ar"]),
            ("bsp", GSPMD_STEPS, lambda rk: rk["runs"]["bsp"]),
            ("qwen", QWEN_GSPMD_STEPS, lambda rk: rk["qwen"])):
        for rk in ranks:
            rr = get_run(rk)
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != steps or bad:
                _fail(f"gspmd run {label} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if device != "cpu" and rr["launches"] != rr["predicted"]:
                _fail(f"gspmd run {label} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")
        rr = get_run(r0)
        what = {"zero1": "llama3.2-1b gspmd zero1", "ar": "llama3.2-1b "
                "gspmd ar", "bsp": "llama3.2-1b BSP asa sharded (fp32 "
                "wire)", "qwen": f"{QWEN_ARCH} gspmd zero1, full width "
                f"({r0['qwen']['layers']} layers)"}[label]
        print(f"phase 13 run, {what}, {steps} steps: " + json.dumps(
            {key: rr[key] for key in show}))
        print(f"phase 13 run, {what}: peak memory per rank, GB: "
              + json.dumps([get_run(rk)["peak_mem_gb"] for rk in ranks])
              + ("" if label == "bsp" else
                 f"; shard elements a rank {rr['shard_numel']:,} of "
                 f"{r0['qwen']['params'] if label == 'qwen' else r0['params']:,}"))
    # (a)'s parity, each rank on its own shards, against GSPMD_REL of the
    # largest movement of that rank's parameters over the GSPMD_STEPS steps
    for rk in ranks:
        za, zb = rk["zero1_vs_ar"], rk["zero1_vs_bsp_max_abs_dp"]
        tol = GSPMD_REL * rk["max_abs_step"]
        print(f"phase 13(a) rank {rk['rank']}: zero1 vs ar max |dp| "
              f"{za['max_abs_dp']} (bitwise {za['bitwise']}), zero1 vs BSP "
              f"asa sharded max |dp| {zb} (bound {tol}: {GSPMD_REL} of the "
              f"largest movement, {rk['max_abs_step']})")
        if not (za["max_abs_dp"] <= tol and zb <= tol):
            _fail(f"gspmd rank {rk['rank']}: zero1 vs ar {za}, vs BSP {zb} "
                  f"> {tol}")
    runs = r0["runs"]
    for name in ("ar", "bsp"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            runs[name]["losses"], runs["zero1"]["losses"]))
        if not rel <= GSPMD_LOSS_RTOL:
            _fail(f"gspmd zero1 and {name} losses differ by {rel}")
    k1 = r0["k1"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["zero1"]["losses"],
                                                   k1["losses"]))
    tol = GSPMD_REL * r0["max_abs_step"]
    print(f"phase 13(a) k=2 vs gspmd k=1 on the global batches (rank 0's "
          f"shards): max |dp| " + json.dumps(k1["max_abs_dp"])
          + f" (bound {tol}), losses within {rel} (bound "
          f"{GSPMD_LOSS_RTOL}); k=1 peak memory {k1['peak_mem_gb']} GB")
    if not (max(k1["max_abs_dp"].values()) <= tol
            and rel <= GSPMD_LOSS_RTOL):
        _fail(f"gspmd k=2 and k=1 differ: {k1['max_abs_dp']}, losses {rel}")
    print(f"phase 13 gspmd step (smoke config, fp32), k=2 on halves vs k=1 "
          f"on the batch: max |dp| " + json.dumps(r0["k2_vs_k1"])
          + f" (bound {K_TOL})")
    if not max(r0["k2_vs_k1"].values()) <= K_TOL:
        _fail(f"gspmd k=2 and k=1 steps differ: {r0['k2_vs_k1']}")
    q = r0["qwen"]
    rel = abs(q["losses"][0] - r0["qwen_k1_loss"]) / abs(r0["qwen_k1_loss"])
    print(f"phase 13(b) {QWEN_ARCH}: first loss {q['losses'][0]} vs a k=1 "
          f"forward of the same parameters {r0['qwen_k1_loss']}: relative "
          f"{rel} (bound {GSPMD_LOSS_RTOL})")
    if not rel <= GSPMD_LOSS_RTOL:
        _fail(f"{QWEN_ARCH} gspmd first loss {q['losses'][0]} vs k=1 "
              f"{r0['qwen_k1_loss']}")
    by_path = {"gspmd_llama": {}, "gspmd_bsp_llama": dict(runs["bsp"][
        "launches"]), "gspmd_qwen": dict(q["launches"])}
    for name in ("zero1", "ar"):
        for n, c in runs[name]["launches"].items():
            by_path["gspmd_llama"][n] = by_path["gspmd_llama"].get(n, 0) + c
    shapes = {}
    for key in ("llama", "qwen"):
        ls = leaves(specs[key])
        packs = _gspmd_packs(specs[key])
        if key == "llama" and packs != r0["packs"]:
            _fail(f"phase 13 gather packs {r0['packs']} != {packs}")
        shapes[key] = ((k, max(packs)),
                       max((s.shard_shape for s in ls), key=math.prod),
                       sorted({s.shard_shape for s in ls}))
    return by_path, shapes


def gspmd_kernel_rows(torch, ref, fa, shapes, flush, dev="cuda"):
    """(c) The kernels of phase 13's paths at their shapes, each held to its
    plain version: ``chunk_sum`` on the fp32 receive buffer of the
    largest gather's reduce-scatter and ``fused_sgd`` on the largest shard
    leaf, of llama3.2-1b and of qwen1.5-4b (bit for bit, as every training
    kernel), and ``fused_sgd`` bit for bit at every distinct shard shape;
    the flash forward and backward at qwen1.5-4b's training shape (1 x
    1024 tokens, 20 heads over 20, D 128, bf16)."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_sgd as fs
    g = torch.Generator(device=dev).manual_seed(1313)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    lr = torch.tensor([0.01], device=dev)
    rows = []

    def row(name, src, line, got, want, fn, plain, library, bound, shape,
            path):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            _fail(f"{name} at {shape} differs from its plain version")
        rows.append(dict(name=name, src=f"src/repro_torch/csrc/{src}",
                         replaces=f"src/repro/kernels/{line}", err=0.0,
                         bound=bound, shape=shape, paths=(path,),
                         ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
                         plain_ms=_median_ms(plain, flush=flush),
                         library_ms=library()))

    for key, arch in (("llama", "llama3.2-1b"), ("qwen", QWEN_ARCH)):
        (kk, n), big, distinct = shapes[key]
        path = f"gspmd_{key}"
        recv = rn(kk, n)
        row("chunk_sum", "exchange.cu", "chunk_sum.py:29",
            cs.chunk_sum(recv), ref.chunk_sum_ref(recv),
            lambda: cs.chunk_sum(recv), lambda: ref.chunk_sum_ref(recv),
            lambda: _median_ms(lambda: torch.sum(recv, 0), flush=flush),
            _bound(3 * n * 4, (kk - 1) * n, FP32_FLOP_S),
            f"{arch} zero1 receive ({kk}, {n}) fp32", path)
        del recv
        p, gr, m = rn(*big) * 0.01, rn(*big) * 0.001, rn(*big) * 0.001
        nb = math.prod(big)

        def library():
            sp = p.clone().requires_grad_(True)
            sp.grad = gr.clone()
            sgd = torch.optim.SGD([sp], lr=0.01, momentum=0.9, fused=True)
            return _event_ms(sgd.step)
        row("fused_sgd", "sgd.cu", "fused_sgd.py:24",
            fs.fused_sgd(p, gr, m, lr, 0.9),
            ref.fused_sgd_ref(p, gr, m, lr, 0.9),
            lambda: fs.fused_sgd(p, gr, m, lr, 0.9),
            lambda: ref.fused_sgd_ref(p, gr, m, lr, 0.9), library,
            _bound(5 * nb * 4, 5 * nb, FP32_FLOP_S),
            f"{arch} shard {tuple(big)} fp32", path)
        del p, gr, m
        if dev != "cpu":
            torch.cuda.empty_cache()
        sgd_check(torch, ref, distinct, f"gspmd {arch} shards", dev=dev)
    # the flash kernels at qwen1.5-4b's training shape
    shape = (1, QWEN_TOKENS if dev != "cpu" else 128, 20, 20, 128)
    fl, c = _lm_flash(torch, ref, fa, flush, shape, 31, dev)
    fwd = fl.pop("fwd")
    q_, k_, v_, qo = (c[n_] for n_ in ("q", "k", "v", "qo"))
    want = ref.flash_attention_ref(q_, k_, v_, qo, 0, c["scale"])
    rows.append(dict(
        name="flash_attention",
        src="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97",
        err=(c["out"].float() - want.float()).abs().max().item(),
        plain_ms=_median_ms(lambda: ref.flash_attention_ref(
            q_, k_, v_, qo, 0, c["scale"]), flush=flush),
        host_ms=_host_ms(lambda: fa.flash_attention(q_, k_, v_, q_off=qo)),
        bound=(fwd.pop("bound_ms"), fwd.pop("bound_by")), **fwd))
    rows += list(fl.values())
    for r in rows[-3:]:
        r.update(shape=f"{QWEN_ARCH} train ({shape[0]}, {shape[1]}, 20/20 "
                 f"heads, D 128) bf16", paths=("gspmd_qwen",))
    print("phase 13(c) kernels at the gspmd paths' shapes, equal to plain: "
          + json.dumps([{k_: r.get(k_) for k_ in (
              "name", "shape", "err", "ms", "plain_ms", "library_ms",
              "bound")} for r in rows]))
    return rows


# ---------------------------------------------------------------------------
# phase 14: the encoder-decoder (SeamlessM4T-v2's backbone)
# ---------------------------------------------------------------------------

SEAMLESS_ARCH = "seamless-m4t-large-v2"
SEAMLESS_PARAMS = 2_034_783_232   # ArchConfig.param_count(); the tree holds
                                  # one more d_model-wide final norm
SEAMLESS_REQUESTS = 4
SEAMLESS_PROMPT = 16              # prompt tokens forced through decode_step
SEAMLESS_NEW = 32                 # greedy tokens after them
SEAMLESS_DECODE_LAYERS = 12       # (a): 12 + 12 of 24 + 24 (the script
                                  # has 1200 s)
SEAMLESS_GRAD_LAYERS = 2          # (b): 2 encoder and 2 decoder layers
SEAMLESS_TRAIN_LAYERS = 2         # (c): 2 + 2 (the script has 1200 s)
SEAMLESS_TRAIN_PARAMS = 650_551_296
SEAMLESS_BATCH, SEAMLESS_TOKENS = 2, 1024   # (b), (c): a rank's sequences
SEAMLESS_STEPS = 3
SEAMLESS_GSPMD_STEPS = 2          # (c): the same config under gspmd zero1
SEAMLESS_POSITIONS = (0, 15, 32, 47)   # (d): the decode's 4 slots over
                                       # (a)'s 48-key lanes


def _encdec_decode(torch, model, params, cache, prompt, new, forced=None):
    """The prompt's tokens through ``decode_step`` one position at a time,
    then ``new`` tokens: greedy, or ``forced``'s (teacher-forced). Returns
    (each step's (B, V) fp32 logits, the (B, S0 + new) tokens), as the
    stepwise ``generate`` runs them."""
    S0 = prompt.shape[1]
    total = S0 + new
    tok = prompt[:, :1]
    toks, logits = [tok], []
    for i in range(total - 1):
        lg, cache = model.decode_step(params, cache, {"tokens": tok}, i,
                                      seq_len=total)
        logits.append(lg[:, -1].float())
        src = prompt if i + 1 < S0 else forced
        tok = (src[:, i + 1:i + 2] if src is not None
               else lg[:, -1].argmax(-1)[:, None])
        toks.append(tok)
    return logits, torch.cat(toks, 1)


def encdec_decode_phase(torch, K, cfg, models, dev):
    """(a) ``cfg`` decoded: bf16 over fp32 masters, 4 requests of
    seeded frames, ``prefill`` (the encoder once, each layer's cross K/V),
    16 prompt tokens forced through ``decode_step``, then 32 greedy
    tokens, launches counted from zero around that run. The kernels
    (``flash_decode`` and its combine) held to the einsum route
    teacher-forced on those tokens, in fp32 at FP32_LOGIT_TOL of the
    largest logit and in bf16 at twice the einsum route's distance from
    its fp32 run; ``generate`` equal bit for bit to the decode loop from a
    zero cross cache (it never runs the encoder, as the reference's).
    Returns {path: launches}."""
    from repro_torch.configs.base import with_attn_impl
    from repro_torch.models.common import dtype_of
    from repro_torch.models.registry import cast_params
    from repro_torch.train.serve import generate
    B, S0, new = SEAMLESS_REQUESTS, SEAMLESS_PROMPT, SEAMLESS_NEW
    total = S0 + new
    cuda = dev.type == "cuda"
    model = models.build_model(cfg, dev)
    master = model.init(torch.Generator(device=dev).manual_seed(14))
    n = models.count_params(master)
    if n != cfg.param_count() + cfg.d_model:
        _fail(f"{cfg.name}: {n} parameters in the tree, not param_count() "
              f"{cfg.param_count()} + the second final norm")
    params = cast_params(master, dtype_of(cfg.dtype))
    g = torch.Generator(device=dev).manual_seed(140)
    frames = torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=g,
                         device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=g,
                           device=dev)
    a = cfg.attention
    cross_want = (cfg.num_layers * B * cfg.encoder_seq_len * a.num_kv_heads
                  * a.head_dim * 2 * torch.finfo(dtype_of(cfg.dtype)).bits
                  // 8)

    # the main run: the kernels in bf16, greedy
    cache = model.init_cache(B, total)
    cross = sum(t.nbytes for t in cache["cross"].values())
    enc_ms = []
    for _ in range(2):                # the first call also warms the card
        _sync(torch, dev)
        t0 = time.perf_counter()
        model.prefill(params, frames, cache)
        _sync(torch, dev)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    K.reset_launches()
    logits, toks = _encdec_decode(torch, model, params, cache, prompt, new)
    _sync(torch, dev)
    launches = dict(K.LAUNCHES)
    want = {"flash_decode": cfg.num_layers * (total - 1),
            "flash_decode_combine": cfg.num_layers * (total - 1)}
    if cuda and launches != want:
        _fail(f"{cfg.name} decode launches {launches} != {want}")
    tok = {"tokens": toks[:, -1:]}
    cost = _step_cost(torch, lambda: model.decode_step(
        params, cache, tok, total - 1, seq_len=total), dev)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    print(f"phase 14(a) {cfg.name} ({cfg.num_encoder_layers} + "
          f"{cfg.num_layers} layers, {n:,} parameters, bf16 over fp32 "
          f"masters), {B} requests of {cfg.encoder_seq_len} frames, {S0} "
          f"prompt + {new} greedy tokens: cross K/V cache {cross:,} bytes "
          f"(reckoned {cross_want:,}); encoder (prefill) "
          f"{enc_ms[1]:.2f} ms (first call {enc_ms[0]:.2f}); a decode step "
          + json.dumps(cost) + f"; launches {launches}; peak memory "
          f"{peak} GB")
    if cross != cross_want:
        _fail(f"cross K/V cache {cross} bytes, reckoned {cross_want}")
    del cache

    # teacher-forced on the main run's tokens: the einsum route in bf16,
    # and both routes in fp32 on the fp32 masters (TF32 off)
    c32 = cfg.with_overrides(dtype="float32")
    outs = {"kernels": logits}
    for name, c, ps in (("plain", with_attn_impl(cfg, "ref"), params),
                        ("kernels_fp32", c32, master),
                        ("plain_fp32", with_attn_impl(c32, "ref"), master)):
        m = models.build_model(c, dev)
        cache = m.prefill(ps, frames, m.init_cache(B, total))
        outs[name], _ = _encdec_decode(torch, m, ps, cache, prompt, new,
                                       forced=toks)
        del cache
    err = lambda x, y: [(p - q).abs().max().item()  # noqa: E731
                        for p, q in zip(outs[x], outs[y])]
    errs, errs32 = err("kernels", "plain"), err("kernels_fp32", "plain_fp32")
    scale = max(t.abs().max().item() for t in outs["plain_fp32"])
    control = max(err("plain", "plain_fp32"))
    top1 = sum(int((p.argmax(-1) == q.argmax(-1)).all())
               for p, q in zip(outs["kernels"], outs["plain"]))
    print(f"phase 14(a) teacher-forced logits ({total - 1} decode steps), "
          f"flash_decode vs einsum attention: bf16 max err {max(errs):.4g} "
          f"(limit {2 * control:.4g}: twice the einsum route's distance "
          f"from its fp32 run), steps with equal top-1 {top1}/{len(errs)}; "
          f"fp32 max err {max(errs32):.4g} of max |logit| {scale:.3f} "
          f"(limit {FP32_LOGIT_TOL * scale:.4g}); distance from fp32, "
          f"kernels {max(err('kernels', 'kernels_fp32')):.4g}")
    if not all(math.isfinite(e) for e in errs + errs32) or (
            max(errs32) > FP32_LOGIT_TOL * scale):
        _fail(f"{cfg.name}: kernels vs einsum decode logits in fp32 differ "
              f"by {max(errs32)} > {FP32_LOGIT_TOL} of {scale}")
    if max(errs) > 2 * control:
        _fail(f"{cfg.name}: kernels vs einsum decode logits in bf16 differ "
              f"by {max(errs)} > {2 * control}")
    del outs

    # generate: the stepwise path, whose cross K/V stay zero
    K.reset_launches()
    got = generate(model, params, prompt, max_new=new)
    _sync(torch, dev)
    gen_launches = dict(K.LAUNCHES)
    zlogits, ztoks = _encdec_decode(torch, model, params,
                                    model.init_cache(B, total), prompt, new)
    gap = (zlogits[0] - logits[0]).abs().max().item()
    print(f"phase 14(a) generate: {tuple(got.shape)} tokens, equal to the "
          f"decode loop's from a zero cross cache bit for bit: "
          f"{torch.equal(got, ztoks)}; the encoder's K/V move the first "
          f"step's logits by up to {gap:.4g} (generate never runs the "
          f"encoder, as the reference's); launches {gen_launches}")
    if not torch.equal(got, ztoks):
        _fail(f"{cfg.name}: generate's tokens differ from the decode loop's")
    if cuda and gen_launches != want:
        _fail(f"{cfg.name} generate launches {gen_launches} != {want}")
    return {"seamless_decode": launches, "seamless_generate": gen_launches}


def _seamless_rank(rank, k, out_dir, device, smoke):
    """One of the 2 ranks of phase 14(c) (a spawned process on ``device``:
    cuda:0, or the CPU with the smoke config to rehearse): BSP through the
    launcher's config, batches, loader and recipe, then the fp32 k=2 vs
    k=1 step at the smoke config."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.launch.train import (launch_config, rank_loader, recipe,
                                          set_fp32_math, synthetic_batch,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()        # the fp32 k=2 vs k=1 check wants full fp32 matmuls
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    cfg = launch_config(dict(arch=SEAMLESS_ARCH, smoke=smoke,
                             layers=None if smoke else SEAMLESS_TRAIN_LAYERS))
    model = build_model(cfg, dev)
    batch, seq = (2, 16) if smoke else (SEAMLESS_BATCH, SEAMLESS_TOKENS)
    files = write_rank_batches(cfg, rank, k, batch, SEAMLESS_STEPS,
                               os.path.join(out_dir, f"s{rank}"), seq=seq)
    loader = rank_loader(cfg, files, dev, SEAMLESS_STEPS, seed=rank)
    opt, lr = recipe(cfg, SEAMLESS_STEPS)
    plan = TrainPlan(exchanger="asa16", sharded_update=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=SEAMLESS_STEPS, log_every=SEAMLESS_STEPS,
                       seed=0, print_fn=lambda *a: None)
    _sync(torch, dev)
    launches = dict(K.LAUNCHES)
    loader.stop()
    n = count_params(state["params"])
    if not smoke and n != SEAMLESS_TRAIN_PARAMS:
        _fail(f"{cfg.name} at {SEAMLESS_TRAIN_LAYERS} + "
              f"{SEAMLESS_TRAIN_LAYERS} layers has {n} parameters, not "
              f"{SEAMLESS_TRAIN_PARAMS:,}")
    rsplan = exchanger.make_rs_plan(state["params"], k)
    ls = leaves(state["params"])
    predicted = _predicted_launches(rsplan, len(ls), "asa16", True,
                                    SEAMLESS_STEPS, cuda, k)
    L = cfg.num_layers
    predicted.update(flash_attention=(2 if cfg.remat else 1) * L
                     * SEAMLESS_STEPS, flash_attention_dq=L * SEAMLESS_STEPS,
                     flash_attention_dkv=L * SEAMLESS_STEPS)
    predicted = _plus(predicted, _halves_launches(
        rsplan, "asa16", _tree_bytes(state["params"]), k))
    out = dict(rank=rank, run=_run_report(torch, rep, launches, {
        n_: c for n_, c in predicted.items() if c}, cuda), params=n,
        layers=[cfg.num_encoder_layers, L], seq=seq,
        frames=cfg.encoder_seq_len,
        buckets=sorted({(b.padded, b.shard_len) for b in rsplan.buckets}),
        small=sorted({tuple(ls[i].shape) for i in rsplan.small}))
    del state, loader
    if cuda:
        torch.cuda.empty_cache()

    # the same config, batch files and recipe under gspmd zero1 (FSDP
    # shards; the encoder-decoder's tree gathered whole each step)
    loader = rank_loader(cfg, files, dev, SEAMLESS_GSPMD_STEPS, seed=rank)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, grep = train(model, opt, recipe(cfg, SEAMLESS_STEPS)[1], loader,
                        plan=TrainPlan(algo="gspmd", mode="zero1"),
                        num_steps=SEAMLESS_GSPMD_STEPS,
                        log_every=SEAMLESS_GSPMD_STEPS, seed=0,
                        print_fn=lambda *a: None)
    _sync(torch, dev)
    loader.stop()
    out["gspmd"] = _run_report(torch, grep, dict(K.LAUNCHES), None, cuda)
    out["gspmd"]["shard_numel"] = sum(p.numel()
                                      for p in leaves(state["params"]))
    del state, model
    if cuda:
        torch.cuda.empty_cache()

    # one fp32 asa step at the smoke config, the decoder's self-attention
    # through the kernels: the two ranks on two halves, then a group of
    # one (rank 0) on the whole batch, from the same parameters
    solo = dist.new_group([0])
    scfg = get_smoke_config(SEAMLESS_ARCH).with_overrides(dtype="float32")
    smodel = build_model(scfg, dev)
    full = {n_: torch.from_numpy(v).to(dev) for n_, v in
            synthetic_batch(scfg, 4, 777, 64).items()}
    half = {n_: v[rank * 2:(rank + 1) * 2] for n_, v in full.items()}
    params = smodel.init(torch.Generator(device=dev).manual_seed(7))
    sstate = {"params": params, "opt": opt.init(params), "step": 0}
    asa = exchanger.get_exchanger("asa")
    two, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01))(sstate, half)
    if rank == 0:
        one, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01),
                                   group=solo)(sstate, full)
        out["k2_vs_k1_max_abs_dp"] = max(
            (a - b).abs().max().item()
            for a, b in zip(leaves(two["params"]), leaves(one["params"])))
        out["k2_vs_k1_max_abs_step"] = max(
            (b - p0).abs().max().item()
            for b, p0 in zip(leaves(one["params"]), leaves(params)))
    dist.barrier()
    with open(os.path.join(out_dir, f"seamless{rank}.json"), "w") as f:
        json.dump(out, f)


def encdec_train_phase(device="cuda:0", smoke=False):
    """(c) Prints what the whole model's training state would take, spawns
    the 2 ranks and checks and prints what they report. Returns (rank 0's
    launches, its (padded, shard) bucket shapes, its small-leaf
    shapes)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_ranks
    k = 2
    full = get_config(SEAMLESS_ARCH)
    n = full.param_count() + full.d_model
    total = (torch.cuda.get_device_properties(0).total_memory
             if torch.cuda.is_available() else float("nan"))
    print(f"phase 14(c) reckoning, {SEAMLESS_ARCH} whole ({n:,} parameters, "
          f"fp32 masters): parameters + gradients + momentum = "
          f"{12 * n / 1e9:.1f} GB a rank, {k * 12 * n / 1e9:.1f} GB for {k}, "
          f"before the wire's buffers and the activations, against the "
          f"card's {total / 1e9:.1f} GB: the run cuts both stacks to "
          f"{SEAMLESS_TRAIN_LAYERS} layers")
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_seamless_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"seamless{r}.json").read_text())
                 for r in range(k)]
    for rk in ranks:
        rr = rk["run"]
        bad = [x for x in rr["losses"] if not math.isfinite(x)]
        if len(rr["losses"]) != SEAMLESS_STEPS or bad:
            _fail(f"seamless run rank {rk['rank']}: losses {rr['losses']}")
        if device != "cpu" and rr["launches"] != rr["predicted"]:
            _fail(f"seamless run rank {rk['rank']}: launches "
                  f"{rr['launches']} != predicted {rr['predicted']}")
    r0 = ranks[0]
    rr = r0["run"]
    frames_s = rr["tokens_per_s"] / r0["seq"] * r0["frames"]
    print(f"phase 14(c) {SEAMLESS_ARCH} at {r0['layers'][0]} + "
          f"{r0['layers'][1]} layers ({r0['params']:,} parameters), BSP "
          f"asa16 sharded on {k} gloo ranks ({device}, {wall:.1f}s), "
          f"{SEAMLESS_STEPS} steps: " + json.dumps(
              {key: rr[key] for key in (
                  "tokens_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "stage_ms_per_step",
                  "wire_ms_per_step", "launches", "predicted", "losses")})
          + f"; frames/s {frames_s:.1f}; first loss {rr['losses'][0]:.4f} "
          f"(ln V = {math.log(full.vocab_size):.4f}); peak memory per "
          f"rank, GB: " + json.dumps([rk["run"]["peak_mem_gb"]
                                      for rk in ranks]))
    # gspmd zero1 of the same run: its first step's loss is BSP's bit for
    # bit (the same parameters and batch; the gather only moves them), its
    # second within GSPMD_LOSS_RTOL (the first update's gradients on
    # zero1's fp32 wire against BSP's fp16 one)
    for rk in ranks:
        g = rk["gspmd"]
        if len(g["losses"]) != SEAMLESS_GSPMD_STEPS or not all(
                math.isfinite(x) for x in g["losses"]):
            _fail(f"seamless gspmd rank {rk['rank']}: losses {g['losses']}")
    g = r0["gspmd"]
    rel = abs(g["losses"][1] - rr["losses"][1]) / abs(rr["losses"][1])
    print(f"phase 14(c) {SEAMLESS_ARCH} at {r0['layers'][0]} + "
          f"{r0['layers'][1]} layers, gspmd zero1 on {k} gloo ranks, "
          f"{SEAMLESS_GSPMD_STEPS} steps: " + json.dumps(
              {key: g[key] for key in (
                  "tokens_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "launches", "losses")})
          + f"; shard elements a rank {g['shard_numel']:,} of "
          f"{r0['params']:,}; first loss {g['losses'][0]!r} vs BSP "
          f"{rr['losses'][0]!r} (bit for bit: "
          f"{g['losses'][0] == rr['losses'][0]}), second within {rel:.3g} "
          f"(bound {GSPMD_LOSS_RTOL}); peak memory per rank, GB: "
          + json.dumps([rk["gspmd"]["peak_mem_gb"] for rk in ranks]))
    if g["losses"][0] != rr["losses"][0] or not rel <= GSPMD_LOSS_RTOL:
        _fail(f"seamless gspmd zero1 losses {g['losses']} vs BSP asa16 "
              f"sharded {rr['losses']}")
    dp = r0["k2_vs_k1_max_abs_dp"]
    print(f"phase 14(c) asa step (smoke config, fp32), k=2 on halves vs k=1 "
          f"on the batch: max |dp| {dp} (bound {K_TOL}; the step moved "
          f"parameters by up to {r0['k2_vs_k1_max_abs_step']})")
    if not dp <= K_TOL:
        _fail(f"seamless k=2 and k=1 asa steps differ by {dp} > {K_TOL}")
    return (dict(rr["launches"]), [tuple(b) for b in r0["buckets"]],
            [tuple(s_) for s_ in r0["small"]])


def encdec_kernel_rows(torch, ref, fa, buckets, small, flush, dev="cuda"):
    """(d) The kernels at phase 14's shapes, each held to its plain version
    and timed: the flash forward, dq and dk/dv at the training shape (2 x
    1024 tokens, 16 heads over 16, D 64, bf16, causal; two backward calls
    bitwise equal); ``flash_decode`` and its combine at (a)'s decode (4
    slots over 48-key lanes, 16/16 heads, D 64, bf16); ``quant_fp16``,
    ``dequant_fp16`` and ``fused_rs_update`` bit for bit at (c)'s largest
    bucket and ``fused_sgd`` at its largest small leaf, then at every
    bucket and small-leaf shape through ``wire_check``/``sgd_check``."""
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import quantize as qz
    g = torch.Generator(device=dev).manual_seed(1414)
    train, decode = ("seamless_train", "seamless_grad"), (
        "seamless_decode", "seamless_generate")
    shape = (2, SEAMLESS_TOKENS if dev != "cpu" else 64, 16, 16, 64)
    fl, c = _lm_flash(torch, ref, fa, flush, shape, 41, dev)
    fwd = fl.pop("fwd")
    q_, k_, v_, qo = (c[n_] for n_ in ("q", "k", "v", "qo"))
    want = ref.flash_attention_ref(q_, k_, v_, qo, 0, c["scale"])
    rows = [dict(
        name="flash_attention",
        src="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97",
        err=(c["out"].float() - want.float()).abs().max().item(),
        plain_ms=_median_ms(lambda: ref.flash_attention_ref(
            q_, k_, v_, qo, 0, c["scale"]), flush=flush),
        host_ms=_host_ms(lambda: fa.flash_attention(q_, k_, v_, q_off=qo)),
        bound=(fwd.pop("bound_ms"), fwd.pop("bound_by")), **fwd)]
    rows += list(fl.values())
    for r in rows:
        r.update(shape=f"{SEAMLESS_ARCH} train ({shape[0]}, {shape[1]}, "
                 f"16/16 heads, D 64) bf16, causal", paths=train)
    dec = _serve_decode(torch, ref, fa, g, 16, 16, 64, torch.bfloat16, flush,
                        SEAMLESS_POSITIONS, SEAMLESS_PROMPT + SEAMLESS_NEW,
                        dev)
    for name in ("flash_decode", "flash_decode_combine"):
        dec[name].update(shape=f"{len(SEAMLESS_POSITIONS)} slots at "
                         f"{list(SEAMLESS_POSITIONS)} over "
                         f"{SEAMLESS_PROMPT + SEAMLESS_NEW} keys, 16/16 "
                         f"heads, D 64, bf16", paths=decode)
        rows.append(dec[name])

    # the wire and update kernels at the largest bucket, the update at the
    # largest small leaf
    padded, s = max(buckets)
    kk = padded // s
    lr = torch.tensor([0.01], device=dev)
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev)  # noqa: E731
    bits = lambda t: t.view({2: torch.int16, 4: torch.int32}[  # noqa: E731
        t.element_size()])

    def row(name, src, line, got, want, fn, plain, library, bound, label):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            _fail(f"{name} at {label} differs from its plain version")
        rows.append(dict(name=name, src=f"src/repro_torch/csrc/{src}",
                         replaces=f"src/repro/kernels/{line}", err=0.0,
                         bound=bound, shape=label, paths=train[:1],
                         ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
                         plain_ms=_median_ms(plain, flush=flush),
                         library_ms=library()))

    x = rn(kk, s)
    h = x.half()
    row("quant_fp16", "exchange.cu", "quantize.py:39", qz.quant_fp16(x),
        ref.quant_fp16_ref(x), lambda: qz.quant_fp16(x),
        lambda: ref.quant_fp16_ref(x),
        lambda: _median_ms(lambda: x.half(), flush=flush),
        _bound(padded * 6, padded, FP32_FLOP_S),
        f"{SEAMLESS_ARCH} bucket ({kk}, {s}) fp32")
    row("dequant_fp16", "exchange.cu", "quantize.py:57", qz.dequant_fp16(h),
        ref.dequant_fp16_ref(h), lambda: qz.dequant_fp16(h),
        lambda: ref.dequant_fp16_ref(h),
        lambda: _median_ms(lambda: h.float(), flush=flush),
        _bound(padded * 6, padded, FP32_FLOP_S),
        f"{SEAMLESS_ARCH} bucket ({kk}, {s}) fp16")
    del x
    ps, ms_, mask = rn(s) * 0.01, rn(s) * 0.001, torch.ones(s, device=dev)
    args = dict(wd_mask=mask, scale=1 / kk, momentum=0.9, weight_decay=1e-4)
    row("fused_rs_update", "sgd.cu", "fused_rs_update.py:53",
        fru.fused_rs_update(h, ps, ms_, lr, **args),
        ref.fused_rs_update_ref(h, ps, ms_, mask, lr, 0.9, False, 1 / kk,
                                1e-4, None),
        lambda: fru.fused_rs_update(h, ps, ms_, lr, **args),
        lambda: ref.fused_rs_update_ref(h, ps, ms_, mask, lr, 0.9, False,
                                        1 / kk, 1e-4, None),
        lambda: None, _bound(padded * 2 + 5 * s * 4, (kk + 7) * s,
                             FP32_FLOP_S),
        f"{SEAMLESS_ARCH} receive ({kk}, {s}) fp16")
    del h, ps, ms_, mask
    sm = max(small, key=math.prod)
    p, gr, m = rn(*sm) * 0.01, rn(*sm) * 0.001, rn(*sm) * 0.001
    nb = math.prod(sm)

    def library():
        sp = p.clone().requires_grad_(True)
        sp.grad = gr.clone()
        sgd = torch.optim.SGD([sp], lr=0.01, momentum=0.9, fused=True)
        return _event_ms(sgd.step)
    row("fused_sgd", "sgd.cu", "fused_sgd.py:24",
        fs.fused_sgd(p, gr, m, lr, 0.9), ref.fused_sgd_ref(p, gr, m, lr, 0.9),
        lambda: fs.fused_sgd(p, gr, m, lr, 0.9),
        lambda: ref.fused_sgd_ref(p, gr, m, lr, 0.9), library,
        _bound(5 * nb * 4, 5 * nb, FP32_FLOP_S),
        f"{SEAMLESS_ARCH} small leaf {tuple(sm)} fp32")
    del p, gr, m
    print("phase 14(d) kernels at the encoder-decoder's shapes, equal to "
          "plain: " + json.dumps([{k_: r.get(k_) for k_ in (
              "name", "shape", "err", "ms", "plain_ms", "library_ms",
              "bound")} for r in rows]))
    wire_check(torch, ref, buckets, SEAMLESS_ARCH, 1e-4, dev=dev)
    sgd_check(torch, ref, small, f"{SEAMLESS_ARCH} small leaves", dev=dev)
    return rows


def encdec_main(torch, ref, fa, K, models, dev="cuda", smoke=False):
    """Phase 14: (a) the model decoded at SEAMLESS_DECODE_LAYERS, (b) the
    gradient check at full width cut to 2 + 2 layers, (c) k=2 BSP at 2 +
    2 layers on gloo ranks sharing the card, (d) the kernels at those
    shapes. Frees the
    card back to the memory it started from. Returns (kernel rows, {path:
    launches})."""
    from repro_torch.configs import get_config, get_smoke_config
    t0 = time.perf_counter()
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    start_mem = 0
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 holds
        torch.backends.cudnn.allow_tf32 = False
        start_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cfg = (get_smoke_config if smoke else get_config)(SEAMLESS_ARCH)
    if not smoke and cfg.param_count() != SEAMLESS_PARAMS:
        _fail(f"{SEAMLESS_ARCH}: param_count {cfg.param_count()} != "
              f"{SEAMLESS_PARAMS:,}")
    by_path = encdec_decode_phase(
        torch, K, cfg if smoke else cfg.with_overrides(
            num_layers=SEAMLESS_DECODE_LAYERS,
            num_encoder_layers=SEAMLESS_DECODE_LAYERS), models, dev)
    if cuda:
        torch.cuda.empty_cache()
    cut = SEAMLESS_GRAD_LAYERS
    by_path["seamless_grad"] = lm_grad_check(
        torch, cfg.with_overrides(num_layers=cut, num_encoder_layers=cut),
        models, dev, shape=(SEAMLESS_BATCH,
                            16 if smoke else SEAMLESS_TOKENS),
        fp32_plain=True)
    if cuda:
        torch.cuda.empty_cache()
    launches, buckets, small = encdec_train_phase(
        "cuda:0" if cuda else "cpu", smoke)
    by_path["seamless_train"] = launches
    l2 = torch.empty(128 * 2 ** 20 if cuda else 1, dtype=torch.uint8,
                     device=dev)
    rows = encdec_kernel_rows(torch, ref, fa, buckets, small, l2.zero_,
                              str(dev))
    del l2
    left = _release_card(torch) - start_mem if cuda else 0
    print(f"phase 14 ({SEAMLESS_ARCH}): {time.perf_counter() - t0:.1f}s, "
          f"{left} bytes left allocated")
    if left > PHASE11_LEFT:
        _fail(f"phase 14 left {left} bytes allocated")
    return rows, by_path


# Phase 15: the roofline and per-program attribution. (c) trains
# llama3.2-1b as phase 6 does, 4 steps, profiling on and then off.
SHARE_LIMIT = 1.05    # a share of a peak above this means the count or
                      # the peak is wrong
MATMUL_N = 8192       # (a): a bf16 N^3 product
SERVE_SPEC = (32, 8, 64)           # llama3.2-1b: heads, KV heads, head dim
HYMBA_SPEC = (25, 5, 64)


def _sig_equal(got: float, want: str) -> bool:
    """``got`` equals the table entry ``want`` to the digits it shows (at
    most 3)."""
    d = min(len(want.replace(".", "").lstrip("0")), 3)
    return float(f"{got:.{d}g}") == float(f"{float(want):.{d}g}")


def _shares(name: str, prof: dict, limit: float = SHARE_LIMIT) -> dict:
    """The program's shares of the peaks, failing above ``limit``."""
    out = {k_: prof[k_] for k_ in ("mfu", "hbm_frac", "coll_frac")
           if k_ in prof}
    bad = {k_: v for k_, v in out.items() if not v <= limit}
    if bad:
        _fail(f"{name}: shares above {limit}: {bad}")
    return out


def _profile_dict(prof) -> dict | None:
    """A ProgramProfile as JSON, its roofline when it has calls."""
    if prof is None:
        return None
    out = dict(flops=prof.flops, hbm_bytes=prof.hbm_bytes,
               coll_bytes=prof.coll_bytes, calls=prof.calls,
               mean_time_s=prof.mean_time_s,
               compile_time_s=prof.compile_time_s, captured=prof.captured,
               kernels=prof.meta.get("kernels", {}),
               collectives=prof.meta.get("collectives", {}),
               host_copy_bytes=prof.meta.get("host_copy_bytes", 0.0),
               host_copies=prof.meta.get("host_copies", {}),
               error=prof.meta.get("capture_error"))
    if prof.captured and prof.calls:
        out.update(prof.roofline())
    return out


def roofline_matmul(torch, tan, peaks, dev="cuda"):
    """(a) A bf16 N^3 cuBLAS product: counted at exactly 2 N^3 flops and
    3 N^2 * 2 bytes, timed, its share of the flops peak gated."""
    n = MATMUL_N if dev != "cpu" else 256
    g = torch.Generator(device=dev).manual_seed(15)
    a = torch.randn(n, n, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(n, n, generator=g, device=dev).to(torch.bfloat16)
    out, m = tan.count_cost(torch.mm, a, b)
    if not (m.flops == 2 * n ** 3 and m.hbm_bytes == 3 * n * n * 2
            and m.errors == 0):
        _fail(f"(a) the {n}^3 product counted {m.flops} flops and "
              f"{m.hbm_bytes} bytes, not {2 * n ** 3} and {3 * n * n * 2}")
    ms = _event_ms(lambda: torch.mm(a, b)) if dev != "cpu" else 1.0
    mfu = m.flops / (ms / 1e3) / peaks["flops"]
    row = dict(n=n, flops=m.flops, bytes=m.hbm_bytes, ms=ms,
               tflop_s=m.flops / ms / 1e9, mfu=mfu)
    print("phase 15(a) bf16 product: " + json.dumps(row))
    if not mfu <= SHARE_LIMIT:
        _fail(f"(a) the product runs at {mfu} of the flops peak")
    return row


def _cost_cases(torch, fa, sg, cs, qz, fs, fru, dev):
    """(b): (label, call at the PERF.md §6 shape, the kernels its launch
    reports with their cost functions' (flops, bytes), the table's bound)
    for one shape of each hand kernel."""
    small = dev == "cpu"
    g = torch.Generator(device=dev).manual_seed(1515)
    bf = torch.bfloat16
    rn = lambda *s, dt=bf: torch.randn(*s, generator=g, device=dev).to(dt)
    pos = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    cases = []

    # row 1: the serve path's prefill chunk, 32 queries at the end of 1 K
    H, KV, D = SERVE_SPEC
    q, k, v = rn(1, 32, H, D), rn(1, 1024, KV, D), rn(1, 1024, KV, D)
    qo = pos(992)
    cases.append(("1 flash_attention serve chunk",
                  lambda: fa.flash_attention(q, k, v, q_off=qo),
                  {"flash_attention": fa.attention_cost(
                      "fwd", 1, 32, 1024, H, KV, D, D, qo, 0, 2)},
                  "0.000704"))
    # rows 2-3: the LM training shape (smaller on the CPU)
    B, S = (1, 128) if small else (4, 1024)
    ql, kl, vl, do = (rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D),
                      rn(B, S, H, D))
    lse = torch.randn(B, S, H, generator=g, device=dev)
    di = torch.randn(B, S, H, generator=g, device=dev)
    z = pos(*[0] * B)
    kw = dict(q_off=z, window=0, sm_scale=0.125)
    cases += [
        ("2 flash_attention_dq LM",
         lambda: fa.flash_attention_dq(ql, kl, vl, lse, do, di, **kw),
         {"flash_attention_dq": fa.attention_cost(
             "dq", B, S, S, H, KV, D, D, z, 0, 2)}, "0.02608"),
        ("3 flash_attention_dkv LM",
         lambda: fa.flash_attention_dkv(ql, kl, vl, lse, do, di, **kw),
         {"flash_attention_dkv": fa.attention_cost(
             "dkv", B, S, S, H, KV, D, D, z, 0, 2)}, "0.03478")]
    # rows 4-5: the serve decode, contiguous and paged; its combine at
    # Hymba's decode (window 1024 over 2 K lanes)
    for label, (h, kvh, d), ps, S_, win, want, want_c in (
            ("serve", SERVE_SPEC, (64, 200, 333, 480, 512, 700, 871, 1000),
             1024, 0, "0.002568", None),
            ("Hymba", HYMBA_SPEC, (100, 700, 1023, 1024, 1100, 1400, 1700,
                                   2047), 2048, 1024, "0.002669",
             "0.000124")):
        P = pos(*ps)
        qd, lk, lv = rn(8, 1, h, d), rn(8, S_, kvh, d), rn(8, S_, kvh, d)
        bk = fa.DEFAULT_DECODE_BLOCK_K
        chunk, ns = fa.decode_plan(S_, bk, _sms(torch, dev))
        want_k = {"flash_decode": fa.decode_cost(P, h, kvh, d, 2, win),
                  "flash_decode_combine": fa.combine_cost(
                      P, h, d, 2, chunk, ns, win)}
        cases.append((f"4 flash_decode {label}",
                      lambda qd=qd, lk=lk, lv=lv, P=P, win=win:
                      fa.flash_decode(qd, lk, lv, P, window=win),
                      want_k, want))
        if want_c:
            cases.append((f"4 flash_decode_combine {label}", None,
                          {"flash_decode_combine":
                           want_k["flash_decode_combine"]}, want_c))
    H, KV, D = SERVE_SPEC
    P = pos(64, 200, 333, 480, 512, 700, 871, 1000)
    kp, vp = rn(8 * 64 + 1, 16, KV, D), rn(8 * 64 + 1, 16, KV, D)
    tables = (torch.arange(8 * 64, device=dev, dtype=torch.int32) + 1
              ).reshape(8, 64)
    qd = rn(8, 1, H, D)
    chunk, ns = fa.decode_plan(1024, 16, _sms(torch, dev))
    cases.append(("5 flash_decode_paged serve",
                  lambda: fa.flash_decode_paged(qd, kp, vp, tables, P,
                                                page_size=16),
                  {"flash_decode_paged": fa.decode_cost(P, H, KV, D, 2, 0,
                                                        16),
                   "flash_decode_combine": fa.combine_cost(
                       P, H, D, 2, chunk, ns, 0)}, "0.002568"))
    # row 6: the sampler at llama3.2-1b's decode
    V = 128256
    lg = rn(8, 1, V)
    oh = torch.ones(8, 1, device=dev)
    T = torch.full((8,), 0.8, device=dev)
    nz = torch.zeros(8, V, device=dev)
    cases.append(("6 slot_gather_sample (8, 1, 128256)",
                  lambda: sg.slot_gather_sample(lg, oh, T, nz),
                  {"slot_gather_sample": sg.sampler_cost(8, 1, V, 2)},
                  "0.001838"))
    # rows 7-13: AlexNet's f6.w bucket and its k=2 shard
    n, sh = (F6_BUCKET, F6_SHARD) if not small else (8192, 4096)
    recv = rn(2, sh, dt=torch.float16)
    x = rn(n, dt=torch.float32)
    h16 = x.half()
    p_, g_, m_ = (rn(n, dt=torch.float32) for _ in range(3))
    ps_, ms_ = rn(sh, dt=torch.float32), rn(sh, dt=torch.float32)
    mask = torch.ones(sh, device=dev)
    q8 = torch.randint(-127, 128, (2, sh), generator=g, device=dev).to(
        torch.int8)
    sc = torch.rand(2, generator=g, device=dev)
    lr = torch.tensor([0.01], device=dev)
    qi, si = qz.quant_int8(x)
    rs = dict(wd_mask=mask, scale=0.5, momentum=0.9, weight_decay=5e-4)
    cases += [
        ("7 chunk_sum f6 shard", lambda: cs.chunk_sum(recv),
         {"chunk_sum": cs.chunk_sum_cost(2, sh, 2)}, "0.0451"),
        ("8 quant_fp16 f6", lambda: qz.quant_fp16(x),
         {"quant_fp16": qz.cast_cost(n, 4, 2)}, "0.0676"),
        ("9 dequant_fp16 f6", lambda: qz.dequant_fp16(h16),
         {"dequant_fp16": qz.cast_cost(n, 2, 4)}, "0.0676"),
        ("10 quant_int8 f6", lambda: qz.quant_int8(x),
         {"quant_int8": qz.int8_cost("quant_int8", n)}, "0.05636"),
        ("11 dequant_int8 f6", lambda: qz.dequant_int8(qi, si),
         {"dequant_int8": qz.int8_cost("dequant_int8", n)}, "0.05636"),
        ("12 fused_sgd f6", lambda: fs.fused_sgd(p_, g_, m_, lr, 0.9),
         {"fused_sgd": fs.fused_sgd_cost(n)}, "0.2254"),
        ("13 fused_rs_update f6 shard",
         lambda: fru.fused_rs_update(recv, ps_, ms_, lr, **rs),
         {"fused_rs_update": fru.fused_rs_update_cost(2, sh, 2, True,
                                                      False)}, "0.1352"),
        ("13 fused_rs_update f6 shard int8",
         lambda: fru.fused_rs_update(q8, ps_, ms_, lr, **rs, scales=sc),
         {"fused_rs_update": fru.fused_rs_update_cost(2, sh, 1, True,
                                                      True)}, "0.1240")]
    # rows 1-3 on the MLA route at its table shape (Dk 576 / Dv 512)
    Bm, Sm = (1, 64) if small else (2, 1024)
    qm, km, vm = rn(Bm, Sm, 16, 576), rn(Bm, Sm, 1, 576), rn(Bm, Sm, 1, 512)
    dom = rn(Bm, Sm, 16, 512)
    lm = torch.randn(Bm, Sm, 16, generator=g, device=dev)
    dim = torch.randn(Bm, Sm, 16, generator=g, device=dev)
    zm = pos(*[0] * Bm)
    kwm = dict(q_off=zm, window=0, sm_scale=0.05)
    chunk, _ = fa.mla_dkv_plan(Bm, Sm, Sm, 16, 1, _sms(torch, dev))
    live = fa.mla_live_partials(Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, chunk)
    cases += [
        ("1 flash_attention_mla MLA",
         lambda: fa.flash_attention(qm, km, vm, q_off=zm, return_lse=True),
         {"flash_attention_mla": fa.attention_cost(
             "fwd", Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, 2, True)},
         "0.03695"),
        ("2 flash_attention_mla_dq MLA",
         lambda: fa.flash_attention_dq(qm, km, vm, lm, dom, dim, **kwm),
         {"flash_attention_mla_dq": fa.attention_cost(
             "dq", Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, 2)}, "0.05651"),
        ("3 flash_attention_mla_dkv MLA",
         lambda: fa.flash_attention_dkv(qm, km, vm, lm, dom, dim, **kwm),
         {"flash_attention_mla_dkv": fa.attention_cost(
             "dkv", Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, 2, partials=live),
          "flash_attention_mla_dkv_reduce": fa.mla_reduce_cost(
              Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, chunk, 2)}, "0.07390"),
        ("3 flash_attention_mla_dkv_reduce MLA", None,
         {"flash_attention_mla_dkv_reduce": fa.mla_reduce_cost(
             Bm, Sm, Sm, 16, 1, 576, 512, zm, 0, chunk, 2)}, "0.01463")]
    return cases


def roofline_kernel_costs(torch, fa, sg, tan, dev="cuda"):
    """(b) Each hand kernel launched at its §6 shape under a CostMode:
    the launch reports its cost function's flops and bytes exactly, and
    the bound of that cost (bytes over 3.35 TB/s or flops over 989
    TFLOP/s) is the table's. A case without a call is a kernel that the
    case before it launched (the combine, the MLA reduction). On the CPU
    the shapes are small and only the counted costs are checked."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import quantize as qz
    out, counted = [], {}
    for label, call, want, bound in _cost_cases(torch, fa, sg, cs, qz, fs,
                                                fru, dev):
        if call is not None:
            with tan.CostMode() as m:
                call()
            if m.errors:
                _fail(f"(b) {label}: {m.first_error}")
            counted = {n: (r["flops"], r["bytes"])
                       for n, r in m.kernels.items()}
        for name, (fl, nb) in want.items():
            if counted.get(name) != (float(fl), float(nb)):
                _fail(f"(b) {label}: {name} counted {counted.get(name)}, "
                      f"its cost function says {(fl, nb)}")
        name = label.split()[1]
        b_ms, b_by = _bound(want[name][1], want[name][0])
        if dev != "cpu" and not _sig_equal(b_ms, bound):
            _fail(f"(b) {label}: bound {b_ms} ms, the table's {bound}")
        out.append(dict(case=label, flops=want[name][0],
                        bytes=want[name][1], bound_ms=b_ms, bound_by=b_by,
                        table=bound))
    print("phase 15(b) each kernel's counted cost = its cost function, "
          "bound = the table's: " + json.dumps(out))
    return out


def _roofline_rank(rank, k, out_dir, device, smoke):
    """(c) One rank: phase 6's LM run again (llama3.2-1b, LM_STEPS steps on
    the same batches and seed), with profiling off."""
    import os

    import torch

    from repro_torch import kernels as K
    from repro_torch import telemetry
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import sgd_momentum, warmup_cosine
    from repro_torch.telemetry import profile
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train

    set_fp32_math()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = (get_smoke_config("llama3.2-1b") if smoke else get_config(
        "llama3.2-1b").with_overrides(num_layers=LM_LAYERS))
    model = build_model(cfg, dev)
    batch, seq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    files = write_rank_batches(cfg, rank, k, batch, LM_STEPS,
                               os.path.join(out_dir, f"roof{rank}"), seq=seq)
    telemetry.configure(profile=False)
    opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                       fused_kernel=fs.fused_sgd)
    loader = rank_loader(cfg, files, dev, LM_STEPS, seed=rank)
    K.reset_launches()
    state, rep = train(model, opt, warmup_cosine(0.01, 2, LM_STEPS), loader,
                       plan=TrainPlan(exchanger="asa16", sharded_update=True),
                       num_steps=LM_STEPS, log_every=LM_STEPS, seed=0,
                       print_fn=lambda *a: None)
    _sync(torch, dev)
    loader.stop()
    out = dict(rank=rank, losses=rep.losses, launches=dict(K.LAUNCHES),
               predicted=_lm_predicted(cfg, state["params"], k,
                                       dev.type == "cuda"),
               tokens_per_s=rep.steady_tokens_per_s,
               first_step_s=rep.first_step_time,
               phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
               profiles=sorted(profile.programs()))
    with open(os.path.join(out_dir, f"roof_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def roofline_train(lm_ranks, device="cuda:0", smoke=False):
    """(c) Phase 6's LM run, profiled at the launcher's defaults
    (``lm_ranks``, what its ranks reported), against the same run with
    profiling off, spawned here: the attribution checks on the first, the
    losses bit for bit equal, the second's launches the prediction with
    no exchange halves. Returns the second run's launches (rank 0's)."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = len(lm_ranks)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_roofline_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        offs = [json.loads(Path(td, f"roof_rank{r}.json").read_text())
                for r in range(k)]
    sums = {}
    for lm, off in zip(lm_ranks, offs):
        r, rk, on = off["rank"], lm["attribution"], lm["main"]
        step = rk["programs"]["train/step"]
        if on["losses"] != off["losses"] or len(off["losses"]) != LM_STEPS:
            _fail(f"(c) rank {r}: losses with profiling {on['losses']} != "
                  f"without {off['losses']}")
        if device != "cpu" and off["launches"] != off["predicted"]:
            _fail(f"(c) rank {r}: launches with profiling off "
                  f"{off['launches']} != predicted {off['predicted']}")
        if off["profiles"]:
            _fail(f"(c) rank {r}: profiling off left profiles "
                  f"{off['profiles']}")
        if not (step and step["captured"] and step["calls"] ==
                LM_STEPS - 1 and step["compile_time_s"] > 0):
            _fail(f"(c) rank {r}: train/step profile {step}")
        for half in ("exchange/rs", "exchange/ag"):
            h = rk["programs"][half]
            if not (h and h["captured"] and h["compile_time_s"] > 0):
                _fail(f"(c) rank {r}: {half} not counted and timed: {h}")
        g = rk["gauges"]
        if not ("train/model_flops_s" in g and "train/mfu" in g):
            _fail(f"(c) rank {r}: gauges {g}")
        if not math.isclose(g["train/mfu"], g["train/model_flops_s"]
                            / rk["peaks"]["flops"], rel_tol=1e-9):
            _fail(f"(c) rank {r}: train/mfu {g['train/mfu']} is not "
                  f"train/model_flops_s over the peak")
        nd = rk["n_params"] * rk["tokens"]
        lo, hi = 6 * nd, 1.1 * (8 * nd + rk["attention_flops"])
        if not lo <= step["flops"] <= hi:
            _fail(f"(c) rank {r}: the step counts {step['flops']} flops, "
                  f"outside [6ND {lo}, 1.1 (8ND + attention) {hi}]")
        shares = {n: _shares(f"(c) rank {r} {n}", p)
                  for n, p in rk["programs"].items() if p}
        shares["train/mfu"] = g["train/mfu"]
        _shares(f"(c) rank {r} train/mfu", {"mfu": g["train/mfu"]})
        for n, sh in shares.items():
            if isinstance(sh, dict):
                for q, v in sh.items():
                    sums[f"{n} {q}"] = sums.get(f"{n} {q}", 0.0) + v
            else:
                sums[n] = sums.get(n, 0.0) + sh
    bad = {n: v for n, v in sums.items() if not v <= SHARE_LIMIT}
    if bad:
        _fail(f"(c) shares summed over the ranks above {SHARE_LIMIT}: {bad}")
    r0 = lm_ranks[0]["attribution"]
    print(f"phase 15(c) llama3.2-1b, {k} gloo ranks, {LM_STEPS} steps: "
          f"phase 6's run (profiled) against the same with profiling off "
          f"({wall:.1f}s): " + json.dumps(dict(
              n_params=r0["n_params"], tokens_a_rank=r0["tokens"],
              six_nd=6 * r0["n_params"] * r0["tokens"],
              attention_flops=r0["attention_flops"],
              programs=r0["programs"], gauges=r0["gauges"],
              tokens_per_s=[lm["attribution"]["tokens_per_s"]
                            for lm in lm_ranks],
              tokens_per_s_off=[off["tokens_per_s"] for off in offs],
              first_step_s=[lm["attribution"]["first_step_s"]
                            for lm in lm_ranks],
              first_step_s_off=[off["first_step_s"] for off in offs],
              phase_ms=lm_ranks[0]["main"]["phase_ms"],
              phase_ms_off=offs[0]["phase_ms"],
              losses=offs[0]["losses"], shares_summed_over_ranks=sums)))
    print("phase 15(c) rank 1's programs: " + json.dumps(
        lm_ranks[1]["attribution"]["programs"]))
    return dict(offs[0]["launches"])


def roofline_serve(torch, K, cfg, models, serve, dev):
    """(d) ``cfg`` served with phase 4's traffic, profiling on: the decode
    step and the prefill chunk counted with the decode's, the combine's
    and the sampler's costs in them, the decode step's bytes at least the
    weights', one argument signature each. Returns the launches."""
    from repro_torch import telemetry
    from repro_torch.telemetry import profile
    from repro_torch.tree import leaves
    model = models.build_model(cfg, dev)
    master = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts, sps = _phase4_requests(cfg, serve)
    telemetry.reset()
    telemetry.configure(profile=True)
    eng = serve.Engine(model, master, max_slots=8, max_seq=1024,
                       prefill_chunk=32, page_size=16, fused_sampling=True,
                       device=dev)
    del master
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves(eng.params))
    for p, sp in zip(prompts, sps):
        eng.submit(p, 32, sp)
    K.reset_launches()
    eng.run()
    _sync(torch, dev)
    launches = dict(K.LAUNCHES)
    progs = {n: _profile_dict(profile.get(n))
             for n in ("serve/decode_step", "serve/prefill_chunk")}
    dec, pre = progs["serve/decode_step"], progs["serve/prefill_chunk"]
    for n, p in progs.items():
        if not (p and p["captured"] and p["calls"] > 0):
            _fail(f"(d) {n} not counted: {p}")
        _shares(f"(d) {n}", p)
    # the counted prefill chunk is a request's first: no token sampled yet
    need = ({"flash_decode_paged", "flash_decode_combine",
             "slot_gather_sample"}, {"flash_attention"})
    if dev.type == "cuda" and not (need[0] <= set(dec["kernels"])
                                   and need[1] <= set(pre["kernels"])):
        _fail(f"(d) the kernels' costs missing: decode {dec['kernels']}, "
              f"prefill {pre['kernels']}")
    if not dec["hbm_bytes"] >= weight_bytes:
        _fail(f"(d) the decode step counts {dec['hbm_bytes']} bytes, under "
              f"the weights' {weight_bytes}")
    if eng.trace_counts.get("decode") != 1 or \
            eng.trace_counts.get("prefill") != 1:
        _fail(f"(d) trace_counts {eng.trace_counts}")
    print(f"phase 15(d) {cfg.name} served, weights {weight_bytes} bytes: "
          + json.dumps(dict(programs=progs, trace_counts=eng.trace_counts,
                            launches=launches)))
    del eng
    torch.cuda.empty_cache()
    return launches


def roofline_main(torch, ref, fa, sg, K, models, serve, cfg_mod, card,
                  lm_ranks=None):
    """Phase 15 from the main process; ``lm_ranks``: what phase 6's ranks
    reported (None: standalone, which runs phase 6 first). Returns
    (kernel rows: standalone, the rows of the paths' kernels timed as
    phases 3 and 6 time them, else none; {path: launches})."""
    from repro_torch.roofline import analysis as tan
    standalone = lm_ranks is None
    t0 = time.perf_counter()
    peaks = tan.peaks()
    print(f"phase 15 peaks {json.dumps(peaks)} on {card}")
    roofline_matmul(torch, tan, peaks)
    roofline_kernel_costs(torch, fa, sg, tan)
    torch.cuda.empty_cache()
    by_path = {}
    if standalone:
        by_path["lm_train"], _, lm_ranks = lm_train_phase()
        torch.cuda.empty_cache()
    by_path["roofline_train"] = roofline_train(lm_ranks)
    torch.cuda.empty_cache()
    by_path["roofline_serve"] = roofline_serve(
        torch, K, cfg_mod.get_config("llama3.2-1b"), models, serve,
        torch.device("cuda"))
    rows = []
    if standalone:
        l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1234)
        rows += list(_serve_flash(torch, ref, fa, g, *SERVE_SPEC,
                                  torch.bfloat16, flush=l2.zero_).values())
        rows.append(_sampler_check(torch, ref, sg, g, 8, 1, 128256,
                                   l2.zero_))
        lm, _ = _lm_flash(torch, ref, fa, l2.zero_,
                          (LM_BATCH, LM_SEQ, *SERVE_SPEC), 11)
        rows += [lm["flash_attention_dq"], lm["flash_attention_dkv"]]
        rows += train_kernel_phase(torch, ref, flush=l2.zero_)[0]
        del l2
        torch.cuda.empty_cache()
        # the rows of the kernels the paths launched, and a row for each
        launched = {n for c in by_path.values() for n, v in c.items() if v}
        rows = [r for r in rows if r["name"] in launched]
        missing = launched - {r["name"] for r in rows}
        if missing:
            _fail(f"phase 15's paths launched {sorted(missing)}, which "
                  f"have no row")
    print(f"phase 15 (roofline): {time.perf_counter() - t0:.1f}s")
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 16: every assigned decoder on the card
# ---------------------------------------------------------------------------

# (a) served at full width, arch -> layers (its bf16 parameters): minitron
# whole; mistral and llama4-scout at the most layers whose bf16 weights
# stay near DeepSeek-V2-Lite's whole 32.3 GB plus about 10 %
ARCHS_SERVE = {"minitron-8b": (32, 9_882_046_464),
               "mistral-large-123b": (12, 17_415_057_408),
               "llama4-scout-17b-a16e": (6, 15_281_587_200)}
LLAMA4_ARCH = "llama4-scout-17b-a16e"
LLAMA4_GRAD_LAYERS = 1       # (d): two ranks do not fit even at 1 layer
LLAMA4_GRAD_TOKENS = 512     # after its 1024 image embeddings
# (c) trained on 2 gloo ranks sharing the card: (arch, algo); BSP asa16
# sharded at 2 x 1024 tokens a rank, gspmd zero1 at 1 x 1024, 2 steps
# each (the script has 1200 s), each at the most layers whose reckoning
# for the two ranks stays at or under ARCHS_MEM_LIMIT
ARCHS_TRAIN = (("mamba2-1.3b", "bsp"), ("hymba-1.5b", "bsp"),
               ("minitron-8b", "gspmd"), ("mistral-large-123b", "gspmd"),
               ("chameleon-34b", "gspmd"))
ARCHS_RUN = {"bsp": (2, 1024, 2), "gspmd": (1, 1024, 2)}  # batch, seq, steps
ARCHS_MEM_LIMIT = 75e9       # two ranks, of the card's 85.0 GB
# gspmd runs stop at this depth where the reckoning allows more (4 layers
# of chameleon-34b and of minitron-8b): their steps wait on gloo's
# staging, which grows with the layers, and the script has 1200 s
ARCHS_GSPMD_MAX_LAYERS = 2
# BSP runs stop at a third of the model's layers though the reckoning
# holds them whole (mamba2's 48 and hymba's 32
# trained whole on two ranks in the chip runs that PERF.md names): a
# step's exchange grows with them
# the reckonings, from phase 13's measured peaks (H100 80GB HBM3): BSP asa16
# sharded took 32.20 GB a rank for llama3.2-1b (1.236e9 parameters, 4 x 1024
# tokens, vocab 128,256): BSP_LOGIT_B bytes a token and vocab entry (the
# bf16 logits, their fp32 copy and its gradient: 5.25 GB there) and
# BSP_PARAM_B bytes a parameter for the rest. gspmd zero1 took 28.57 GB a
# rank for qwen1.5-4b: 4 B a parameter (the fp32 shards of parameters and
# momentum at k = 2), 8 B a parameter of the embedding, the untied head and
# the largest layer (each gathered in fp32, with its gradient buffer), and
# GSPMD_ACT_B of activations and logits
BSP_PARAM_B, BSP_LOGIT_B = 21.8, 10
GSPMD_ACT_B = 6e9
# what (c) measured, arch -> {algo, layers, peaks a rank (GB), reckoning
# (bytes)}: phase 17(b) holds the dry run's prediction to it
ARCHS_MEASURED: dict = {}


def _archs_reckoning(cfg, algo: str, layers: int, k: int = 2) -> float:
    """Bytes a rank of ``cfg`` cut to ``layers`` layers by the reckoning
    above, from the parameter tree's shapes (on the meta device)."""
    from repro_torch.core.gspmd import abstract_params
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    p = abstract_params(build_model(cfg.with_overrides(num_layers=layers),
                                    "meta"))
    n = lambda tree: sum(t.numel() for t in leaves(tree))  # noqa: E731
    total = n(p)
    if algo == "bsp":
        batch, seq, _ = ARCHS_RUN["bsp"]
        return BSP_PARAM_B * total + BSP_LOGIT_B * batch * seq * \
            cfg.vocab_size
    big = n(p.get("embed", {})) + n(p.get("head", {})) + max(
        n(lp) for lp in p["layers"])
    return 4 * 2 / k * total + 8 * big + GSPMD_ACT_B


def _archs_depth(cfg, algo: str, k: int = 2) -> tuple:
    """(layers, bytes a rank, the most layers the reckoning allows): the
    most layers up to ARCHS_GSPMD_MAX_LAYERS (gspmd) or a third of the
    config's (BSP) whose reckoning for the k ranks stays at or under
    ARCHS_MEM_LIMIT."""
    best = None
    for L in range(1, cfg.num_layers + 1):
        r = _archs_reckoning(cfg, algo, L, k)
        if k * r > ARCHS_MEM_LIMIT:
            break
        best = (L, r)
    if best is None:
        _fail(f"{cfg.name} does not fit {k} ranks at 1 layer: "
              f"{k * _archs_reckoning(cfg, algo, 1, k) / 1e9:.1f} GB")
    most = best[0]
    cap = (ARCHS_GSPMD_MAX_LAYERS if algo == "gspmd" else
           cfg.num_layers // 3)
    if most > cap:
        best = (cap, _archs_reckoning(cfg, algo, cap, k))
    return best + (most,)


def archs_engine_phase(torch, K, cfg, models, serve, dev, want_params):
    """(a) ``cfg`` (its depth cut already applied; random weights in the
    compute dtype from a seeded generator on ``dev``) through the Engine
    with phase 4's traffic, after a printed reckoning of its memory:
    every kernel of the path launched, the sampler at (8, 1, V) and (1,
    32, V) alone; decode tok/s, p50/p99, one decode step's host ms and
    device operations, the peak; a short contiguous pass that reaches
    ``flash_decode``; then the teacher-forced check, the kernels held to
    the einsum attention in fp32 at FP32_LOGIT_TOL and in bf16 at twice
    the einsum route's distance from fp32, its fp32 runs on the
    parameters cast in place. Returns the paths' launches."""
    cfg = cfg.with_overrides(param_dtype=cfg.dtype)
    cuda = dev.type == "cuda"
    a = cfg.attention
    es = 2
    kv_token = 2 * cfg.num_layers * a.num_kv_heads * a.head_dim * es
    pages = 8 * 1024 // 16 + 1
    print(f"phase 16(a) reckoning, {cfg.name} at {cfg.num_layers} layers "
          f"({want_params:,} parameters): bf16 weights "
          f"{want_params * es / 1e9:.1f} GB, KV {kv_token // 1024} KiB a "
          f"token, the paged pool {pages} pages of 16 = "
          f"{pages * 16 * kv_token / 1e9:.2f} GB; the fp32 runs of the "
          f"teacher-forced check {want_params * 4 / 1e9:.1f} GB")
    model = models.build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    n = models.count_params(params)
    print(f"{cfg.name}: init {n:,} params ({cfg.dtype}) in "
          f"{time.perf_counter() - t0:.1f}s")
    if cuda and n != want_params:
        _fail(f"{cfg.name} has {n} parameters, not {want_params:,}")
    prompts, sps = _phase4_requests(cfg, serve)
    shape = dict(max_slots=8, max_seq=1024, prefill_chunk=32, page_size=16,
                 fused_sampling=True, device=dev)
    eng = serve.Engine(model, params, **shape)
    del params
    rids = [eng.submit(p, 32, sp) for p, sp in zip(prompts, sps)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name in ("flash_attention", "flash_decode_paged",
                 "flash_decode_combine", "slot_gather_sample"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was not launched serving {cfg.name}")
    shapes = {s_: c for (n_, s_), c in K.LAUNCH_SHAPES.items()
              if n_ == "slot_gather_sample"}
    V = cfg.vocab_size
    if (set(shapes) - {(8, 1, V), (1, 32, V)}
            or sum(shapes.values()) != launches["slot_gather_sample"]):
        _fail(f"{cfg.name}: the sampler ran at {shapes}, "
              f"{launches['slot_gather_sample']} launches in all")
    launches.update({_shape_key("slot_gather_sample", s_): c
                     for s_, c in shapes.items()})
    for r in rids:
        out = results[int(r)]
        if len(out) != 32 or not all(0 <= t < V for t in out):
            _fail(f"{cfg.name} request {int(r)} returned {len(out)} tokens")
    st, al = eng.stats, eng.allocator
    if al.hits <= 0:
        _fail(f"{cfg.name}: the shared-prefix request took no prefix hit")
    stats = dict(
        params=n, layers=cfg.num_layers, requests=len(rids), wall_s=wall,
        prefill_tokens=st.prefill_tokens, prefill_tok_s=st.prefill_tok_s(),
        decode_steps=st.steps, decoded_tokens=st.decoded_tokens,
        decode_tok_s=st.decode_tok_s(), prefix_hit_pages=al.hits,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                     else None),
        token_latency_ms={str(q): v * 1e3 for q, v in
                          st.token_latency_percentiles().items()},
        launches=launches)
    print(f"engine {cfg.name} " + json.dumps(stats))
    print(f"decode step ({cfg.name}, 8 slots, pages of 16): "
          + json.dumps(_decode_step_cost(torch, model, eng.params, dev)))
    # the contiguous pool: the path that reaches flash_decode
    eng0 = serve.Engine(model, eng.params, **dict(shape, max_slots=4,
                                                  max_seq=256, page_size=0))
    rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
    K.reset_launches()
    res0 = eng0.run()
    _sync(torch, dev)
    launches["flash_decode"] = K.LAUNCHES.get("flash_decode", 0)
    launches["flash_decode_combine"] += K.LAUNCHES.get(
        "flash_decode_combine", 0)
    if launches["flash_decode"] <= 0:
        _fail(f"flash_decode was not launched by {cfg.name}'s contiguous "
              f"engine run")
    if any(len(res0[int(r)]) != 8 for r in rids0):
        _fail(f"{cfg.name}: the contiguous engine run did not finish")
    params = eng.params
    del eng0, eng, model
    if cuda:
        torch.cuda.empty_cache()
    check_flash_vs_ref(torch, cfg, models, params,
                       [p[:64] for p in prompts if len(p) >= 64][:2], dev,
                       consume=True)
    return launches


def _host_peak_gb() -> float:
    """This process's peak resident host memory in GB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _archs_rank(rank, k, out_dir, device, smoke, cuts):
    """One of the 2 ranks of phase 16(c) (a spawned process on ``device``:
    cuda:0, or the CPU with smoke configs to rehearse): each of
    ARCHS_TRAIN through the launcher's config (``cuts``: arch -> layers),
    batch files, loader and recipe, after rank 0's k=1 forward of the
    same parameters on the run's first global batch."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.core import exchanger
    from repro_torch.core.gspmd import abstract_params, fsdp_shardings
    from repro_torch.launch.train import (launch_config, rank_loader, recipe,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    out = {"rank": rank, "runs": {}}

    def free():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            # the gloo staging's pinned blocks, which the caching host
            # allocator keeps: one run's may not fit the next one's
            for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
                if hasattr(torch._C, name):
                    getattr(torch._C, name)()
                    break

    for arch, algo in ARCHS_TRAIN:
        cfg = launch_config(dict(arch=arch, smoke=smoke, layers=cuts[arch]))
        model = build_model(cfg, dev)
        batch, seq, steps = ARCHS_RUN[algo]
        seq = 64 if smoke else seq
        files = write_rank_batches(cfg, rank, k, batch, steps,
                                   os.path.join(out_dir, f"{arch}{rank}"),
                                   seq=seq)
        run = {}
        if rank == 0:
            # the first step's loss at k=1: the loop's initial parameters
            # (seed 0) forward on the global batch, no gradient
            with torch.no_grad():
                p0 = model.init(torch.Generator(device=dev).manual_seed(0))
                loss1, _ = model.loss_fn(p0, _global_batch(
                    torch, cfg, k, batch, seq, 0, dev))
                run["k1_loss"] = float(loss1)
                del p0, loss1
            free()
        dist.barrier()
        plan = (TrainPlan(exchanger="asa16", sharded_update=True)
                if algo == "bsp" else TrainPlan(algo="gspmd", mode="zero1"))
        opt, lr = recipe(cfg, steps)
        loader = rank_loader(cfg, files, dev, steps, seed=rank)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        state, rep = train(model, opt, lr, loader, plan=plan,
                           num_steps=steps, log_every=steps, seed=0,
                           print_fn=lambda *a: None)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        loader.stop()
        ls = leaves(state["params"])
        L = cfg.num_layers
        if algo == "bsp":
            rsplan = exchanger.make_rs_plan(state["params"], k)
            predicted = _predicted_launches(rsplan, len(ls), "asa16", True,
                                            steps, cuda, k)
            if cfg.attention is not None:
                predicted.update(flash_attention=(2 if cfg.remat else 1) * L
                                 * steps, flash_attention_dq=L * steps,
                                 flash_attention_dkv=L * steps)
            predicted = _plus(predicted, _halves_launches(
                rsplan, "asa16", _tree_bytes(state["params"]), k))
            n = count_params(state["params"])
            run.update(buckets=sorted({(b.padded, b.shard_len)
                                       for b in rsplan.buckets}),
                       small=sorted({tuple(ls[i].shape)
                                     for i in rsplan.small}))
        else:
            predicted = _gspmd_predicted(cfg, len(ls), steps, "zero1")
            specs = fsdp_shardings(abstract_params(model), k)
            n = count_params(abstract_params(model))
            run.update(packs=_gspmd_packs(specs),
                       shards=sorted({s.shard_shape for s in leaves(specs)}),
                       shard_numel=sum(p.numel() for p in ls))
        run.update(_run_report(torch, rep, launches, {
            n_: c for n_, c in predicted.items() if c}, cuda),
            algo=algo, params=n, layers=L, tokens=batch * seq, wall_s=wall,
            host_peak_gb=_host_peak_gb())
        out["runs"][arch] = run
        del state, model, ls, rep
        free()
        dist.barrier()
    with open(os.path.join(out_dir, f"archs{rank}.json"), "w") as f:
        json.dump(out, f)


def archs_train_phase(device="cuda:0", smoke=False):
    """(c) Prints each run's depth and reckoning, spawns the 2 ranks once
    for all of ARCHS_TRAIN, and checks and prints what they report: finite
    losses, launches equal to the prediction, the first loss held to rank
    0's k=1 forward at GSPMD_LOSS_RTOL (phase 13(b)'s hold; whether it is
    bit for bit is printed: bf16 products at another batch may sum in
    another order), the peak a rank beside its reckoning.
    Returns ({path: rank 0's launches}, {arch: its run's shapes})."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_ranks
    k = 2
    cuts, reckon = {}, {}
    for arch, algo in ARCHS_TRAIN:
        cfg = get_config(arch)
        L, r, most = _archs_depth(cfg, algo, k)
        cuts[arch] = None if smoke else L
        reckon[arch] = r
        batch, seq, steps = ARCHS_RUN[algo]
        print(f"phase 16(c) reckoning, {arch} {algo} "
              f"{'asa16 sharded' if algo == 'bsp' else 'zero1'}, {batch} x "
              f"{seq} tokens a rank, {steps} steps: {L} of "
              f"{cfg.num_layers} layers, {r / 1e9:.2f} GB a rank, "
              f"{k * r / 1e9:.2f} GB for {k} (limit "
              f"{ARCHS_MEM_LIMIT / 1e9:.0f}); the reckoning allows "
              + (f"{most}, {most + 1} would take "
                 f"{k * _archs_reckoning(cfg, algo, most + 1, k) / 1e9:.2f}"
                 f" GB" if most < cfg.num_layers else "the whole model")
              if L < cfg.num_layers else
              f"phase 16(c) reckoning, {arch} {algo} asa16 sharded, {batch} "
              f"x {seq} tokens a rank, {steps} steps: whole ({L} layers), "
              f"{r / 1e9:.2f} GB a rank, {k * r / 1e9:.2f} GB for {k} "
              f"(limit {ARCHS_MEM_LIMIT / 1e9:.0f})")
    if torch.cuda.is_available():
        free_b, total_b = torch.cuda.mem_get_info()
        print(f"phase 16(c): the card's free memory before the ranks start "
              f"{free_b / 1e9:.2f} of {total_b / 1e9:.2f} GB; this process "
              f"peaked at {_host_peak_gb():.1f} GB of host memory")
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            run_ranks(_archs_rank, k, (td, device, smoke, cuts),
                      backend="gloo")
            wall = time.perf_counter() - t0
            ranks = [json.loads(Path(td, f"archs{r}.json").read_text())
                     for r in range(k)]
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    print(f"phase 16(c): {k} gloo ranks on {device}, {wall:.1f}s")
    by_path, shapes = {}, {}
    for arch, algo in ARCHS_TRAIN:
        steps = ARCHS_RUN[algo][2]
        for rk in ranks:
            rr = rk["runs"][arch]
            if len(rr["losses"]) != steps or not all(
                    math.isfinite(x) for x in rr["losses"]):
                _fail(f"{arch} {algo} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if device != "cpu" and rr["launches"] != rr["predicted"]:
                _fail(f"{arch} {algo} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")
        rr = ranks[0]["runs"][arch]
        first, k1 = rr["losses"][0], rr["k1_loss"]
        peaks = [rk["runs"][arch]["peak_mem_gb"] for rk in ranks]
        print(f"phase 16(c) {arch} {algo} at {rr['layers']} layers "
              f"({rr['params']:,} parameters), {steps} steps: " + json.dumps(
                  {key: rr[key] for key in (
                      "tokens_per_s", "first_step_s", "phase_ms",
                      "staged_mb_per_step", "stage_ms_per_step",
                      "wire_ms_per_step", "launches", "predicted", "losses",
                      "wall_s", "host_peak_gb")})
              + f"; first loss {first!r} vs a k=1 forward {k1!r} (bit for "
              f"bit: {first == k1}, relative {abs(first - k1) / abs(k1):.3g}, "
              f"bound {GSPMD_LOSS_RTOL}); peak memory per rank, GB: "
              + json.dumps(peaks) + f" against the reckoning "
              f"{reckon[arch] / 1e9:.2f}")
        if not abs(first - k1) <= GSPMD_LOSS_RTOL * abs(k1):
            _fail(f"{arch} {algo}: first loss {first!r} vs k=1 {k1!r}")
        by_path[f"archs_{algo}_{arch}"] = dict(rr["launches"])
        shapes[arch] = {key: rr[key] for key in ("algo", "buckets", "small",
                                                 "packs", "shards")
                        if key in rr}
        ARCHS_MEASURED[arch] = dict(algo=algo, layers=rr["layers"],
                                    peaks=peaks, reckoning=reckon[arch])
    return by_path, shapes


def archs_kernel_rows(torch, ref, fa, sg, cfgs, shapes, flush, dev="cuda"):
    """(b) The kernels at phase 16's shapes, each held to its plain version
    and timed beside it, its library call and its bound: the serve
    path's prefill chunk and both decodes (with the combine) at each
    served model's heads (_serve_flash); the sampler bit for bit at (8,
    1, V) and (1, 32, V) of each served vocab (its plan printed; the
    profiler's count of one operation stays in phase 3); the flash
    forward, dq and dk/dv in bf16 at minitron's and mistral's gspmd
    training shape (1 x 1024) and at llama4-scout's gradient check (1 x
    1536 after its image prefix), two backward calls bitwise equal; the
    training kernels at (c)'s shapes: chunk_sum on each gspmd model's
    largest fp32 receive and fused_sgd on its largest shard (then every
    distinct shard bit for bit), the fp16 casts and fused_rs_update at
    each BSP model's largest bucket (then every bucket through
    wire_check, every small leaf through sgd_check). ``cfgs``: arch ->
    the served or trained config. Returns the rows."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import quantize as qz
    g = torch.Generator(device=dev).manual_seed(1616)
    rows = []
    cpu = str(dev) == "cpu"
    for arch in ARCHS_SERVE:
        cfg = cfgs[arch]
        a = cfg.attention
        H, KV, D = a.num_heads, a.num_kv_heads, a.head_dim
        fl = _serve_flash(torch, ref, fa, g, H, KV, D, torch.bfloat16, flush,
                          dev)
        for name, r in fl.items():
            r.update(shape=f"{arch} serve ({H}/{KV} heads, D {D}) bf16",
                     paths=("serve_" + arch,))
            rows.append(r)
        for S_, C in ((8, 1), (1, 32)):
            V = cfg.vocab_size
            r = _sampler_check(torch, ref, sg, g, S_, C, V, flush, dev,
                               count_ops=False)
            rows.append(dict(r, shape=f"({S_}, {C}, {V}) bf16",
                             paths=("serve_" + arch,),
                             count_key=_shape_key(r["name"], (S_, C, V))))
            print(f"slot_gather_sample ({S_}, {C}, {V}) ({arch}), equal to "
                  f"plain bit for bit, library = argmax of these selected "
                  f"rows: " + json.dumps({k_: r[k_] for k_ in (
                      "plan", "ms", "plain_ms", "library_ms", "host_ms",
                      "bound")}))
    lm_tokens = 128 if cpu else 1024
    for arch, tokens, path in (
            ("minitron-8b", lm_tokens, "archs_gspmd_minitron-8b"),
            ("mistral-large-123b", lm_tokens,
             "archs_gspmd_mistral-large-123b"),
            (LLAMA4_ARCH, (64 if cpu else LLAMA4_GRAD_TOKENS)
             + cfgs[LLAMA4_ARCH].num_image_tokens, "grad_" + LLAMA4_ARCH)):
        a = cfgs[arch].attention
        shape = (1, tokens, a.num_heads, a.num_kv_heads, a.head_dim)
        fl, c = _lm_flash(torch, ref, fa, flush, shape, 61, dev)
        fwd = fl.pop("fwd")
        q_, k_, v_, qo = (c[n_] for n_ in ("q", "k", "v", "qo"))
        want = ref.flash_attention_ref(q_, k_, v_, qo, 0, c["scale"])
        part = [dict(
            name="flash_attention",
            src="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:97",
            err=(c["out"].float() - want.float()).abs().max().item(),
            plain_ms=_median_ms(lambda: ref.flash_attention_ref(
                q_, k_, v_, qo, 0, c["scale"]), flush=flush),
            host_ms=_host_ms(lambda: fa.flash_attention(q_, k_, v_,
                                                        q_off=qo)),
            bound=(fwd.pop("bound_ms"), fwd.pop("bound_by")), **fwd)]
        part += list(fl.values())
        for r in part:
            r.update(shape=f"{arch} train {shape[:2]}, {shape[2]}/{shape[3]} "
                     f"heads, D {shape[4]}, bf16, causal", paths=(path,))
        rows += part
        del fl, c, q_, k_, v_, want
    lr = torch.tensor([0.01], device=dev)
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev)  # noqa: E731
    bits = lambda t: t.view({2: torch.int16, 4: torch.int32}[  # noqa: E731
        t.element_size()])

    def row(name, src, line, got, want, fn, plain, library, bound, label,
            path):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            _fail(f"{name} at {label} differs from its plain version")
        rows.append(dict(name=name, src=f"src/repro_torch/csrc/{src}",
                         replaces=f"src/repro/kernels/{line}", err=0.0,
                         bound=bound, shape=label, paths=(path,),
                         ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
                         plain_ms=_median_ms(plain, flush=flush),
                         library_ms=library()))

    def sgd_library(p, gr):
        sp = p.clone().requires_grad_(True)
        sp.grad = gr.clone()
        sgd = torch.optim.SGD([sp], lr=0.01, momentum=0.9, fused=True)
        return _event_ms(sgd.step)
    for arch, algo in ARCHS_TRAIN:
        sh, path = shapes[arch], f"archs_{algo}_{arch}"
        if algo == "gspmd":
            n = max(sh["packs"])
            recv = rn(2, n)
            row("chunk_sum", "exchange.cu", "chunk_sum.py:29",
                cs.chunk_sum(recv), ref.chunk_sum_ref(recv),
                lambda: cs.chunk_sum(recv), lambda: ref.chunk_sum_ref(recv),
                lambda: _median_ms(lambda: torch.sum(recv, 0), flush=flush),
                _bound(3 * n * 4, n, FP32_FLOP_S),
                f"{arch} zero1 receive (2, {n}) fp32", path)
            del recv
            big = max((tuple(s_) for s_ in sh["shards"]), key=math.prod)
            p, gr, m = rn(*big) * 0.01, rn(*big) * 0.001, rn(*big) * 0.001
            nb = math.prod(big)
            row("fused_sgd", "sgd.cu", "fused_sgd.py:24",
                fs.fused_sgd(p, gr, m, lr, 0.9),
                ref.fused_sgd_ref(p, gr, m, lr, 0.9),
                lambda: fs.fused_sgd(p, gr, m, lr, 0.9),
                lambda: ref.fused_sgd_ref(p, gr, m, lr, 0.9),
                lambda: sgd_library(p, gr),
                _bound(5 * nb * 4, 5 * nb, FP32_FLOP_S),
                f"{arch} shard {big} fp32", path)
            del p, gr, m
            sgd_check(torch, ref, [tuple(s_) for s_ in sh["shards"]],
                      f"{arch} gspmd shards", dev=dev)
        else:
            buckets = [tuple(b) for b in sh["buckets"]]
            padded, s = max(buckets)
            x = rn(2, s)
            h = x.half()
            row("quant_fp16", "exchange.cu", "quantize.py:39",
                qz.quant_fp16(x), ref.quant_fp16_ref(x),
                lambda: qz.quant_fp16(x), lambda: ref.quant_fp16_ref(x),
                lambda: _median_ms(lambda: x.half(), flush=flush),
                _bound(padded * 6, padded, FP32_FLOP_S),
                f"{arch} bucket (2, {s}) fp32", path)
            row("dequant_fp16", "exchange.cu", "quantize.py:57",
                qz.dequant_fp16(h), ref.dequant_fp16_ref(h),
                lambda: qz.dequant_fp16(h), lambda: ref.dequant_fp16_ref(h),
                lambda: _median_ms(lambda: h.float(), flush=flush),
                _bound(padded * 6, padded, FP32_FLOP_S),
                f"{arch} bucket (2, {s}) fp16", path)
            del x
            ps, ms_ = rn(s) * 0.01, rn(s) * 0.001
            mask = torch.ones(s, device=dev)
            kw = dict(wd_mask=mask, scale=0.5, momentum=0.9,
                      weight_decay=1e-4)
            row("fused_rs_update", "sgd.cu", "fused_rs_update.py:53",
                fru.fused_rs_update(h, ps, ms_, lr, **kw),
                ref.fused_rs_update_ref(h, ps, ms_, mask, lr, 0.9, False, 0.5,
                                        1e-4, None),
                lambda: fru.fused_rs_update(h, ps, ms_, lr, **kw),
                lambda: ref.fused_rs_update_ref(h, ps, ms_, mask, lr, 0.9,
                                                False, 0.5, 1e-4, None),
                lambda: None, _bound(padded * 2 + 5 * s * 4, 9 * s,
                                     FP32_FLOP_S),
                f"{arch} receive (2, {s}) fp16", path)
            del h, ps, ms_, mask
            wire_check(torch, ref, buckets, f"{arch} BSP", 1e-4, dev=dev)
            sgd_check(torch, ref, [tuple(s_) for s_ in sh["small"]],
                      f"{arch} small leaves", dev=dev)
        if not cpu:
            torch.cuda.empty_cache()
    print("phase 16(b) kernels at the new shapes, equal to plain: "
          + json.dumps([{k_: r.get(k_) for k_ in (
              "name", "shape", "err", "rel_err", "ms", "plain_ms",
              "library_ms", "bound")} for r in rows]))
    return rows


def archs_main(torch, ref, fa, sg, K, models, serve, dev="cuda",
               smoke=False):
    """Phase 16: (a) minitron-8b, mistral-large-123b and llama4-scout served
    at ARCHS_SERVE's depths, (d) llama4-scout's gradient check at 1 layer,
    (c) ARCHS_TRAIN on 2 gloo ranks, (b) the kernels at those shapes.
    Frees the card back to the memory it started from. Returns (kernel
    rows, {path: launches})."""
    from repro_torch.configs import get_config, get_smoke_config
    t0 = time.perf_counter()
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    start_mem = 0
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 holds
        torch.backends.cudnn.allow_tf32 = False
        start_mem = torch.cuda.memory_allocated()
    get = get_smoke_config if smoke else get_config
    cfgs, by_path = {}, {}
    for arch, (layers, n) in ARCHS_SERVE.items():
        cfg = get(arch)
        if not smoke:
            cfg = cfg.with_overrides(num_layers=layers)
        cfgs[arch] = cfg
        by_path["serve_" + arch] = archs_engine_phase(
            torch, K, cfg, models, serve, dev, n)
        if cuda:
            _release_card(torch)
    l4 = cfgs[LLAMA4_ARCH].with_overrides(num_layers=LLAMA4_GRAD_LAYERS)
    reck = (l4.param_count() if not smoke else 0) * 4
    print(f"phase 16(d) reckoning, {LLAMA4_ARCH} at {LLAMA4_GRAD_LAYERS} "
          f"layer: fp32 masters {reck / 1e9:.1f} GB and three runs' "
          f"gradients {3 * reck / 1e9:.1f} GB in one process; on two gloo "
          f"ranks its gspmd zero1 reckoning is "
          f"{_archs_reckoning(get_config(LLAMA4_ARCH), 'gspmd', 1) / 1e9:.1f}"
          f" GB a rank, past the card's 85.0 GB for two")
    by_path["grad_" + LLAMA4_ARCH] = lm_grad_check(
        torch, l4, models, dev,
        shape=(1, 64 if smoke else LLAMA4_GRAD_TOKENS),
        image_tokens=l4.num_image_tokens)
    if cuda:
        _release_card(torch)
    train_paths, shapes = archs_train_phase("cuda:0" if cuda else "cpu",
                                            smoke)
    by_path.update(train_paths)
    l2 = torch.empty(128 * 2 ** 20 if cuda else 1, dtype=torch.uint8,
                     device=dev)
    rows = archs_kernel_rows(torch, ref, fa, sg, cfgs, shapes, l2.zero_,
                             str(dev))
    del l2
    left = _release_card(torch) - start_mem if cuda else 0
    print(f"phase 16 (archs): {time.perf_counter() - t0:.1f}s, {left} bytes "
          f"left allocated")
    if left > PHASE11_LEFT:
        _fail(f"phase 16 left {left} bytes allocated")
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 17: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

DRYRUN_PEAK_TOL = 0.10    # the dry run's predicted peak a rank (argument +
#                           temp) against max_memory_allocated of the run
DRYRUN_ROW = ("mistral-large-123b", "train_4k")   # (c): fsdp on 16 x 16
DRYRUN_LABEL = "dry run, meta device, H100 SXM peaks"
# 17(a): the LM step's copies across host and card that are not the gloo
# transport's staging (its ``copy_`` into and out of pinned buffers): the
# flash kernels' cost functions reading their (B,) positions on the host
# (``flash_attention.host_offsets``, under the CostMode alone), once for
# each layer's forward, its recomputation, dq and dk/dv
LM_STEP_SCALAR_COPIES = {
    f"aten._to_copy int32[{LM_BATCH}] to host": 4 * LM_LAYERS}


def _dry_train(cfg, batch: int, seq: int, algo: str, steps: int,
               optimizer, lr_fn, k: int = 2):
    """The dry run of one rank's first step of a k-rank run of ``cfg``
    (``batch`` x ``seq`` tokens a rank) at mesh ``data=k``: BSP asa16
    sharded or gspmd zero1, with the run's optimizer and schedule, the
    exchange bucketed a leaf a bucket as the training loop does. Returns
    ``analyze_program``'s dict."""
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.sharding import Mesh
    from repro_torch.launch import dryrun as D
    mesh = Mesh(("data",), (k,))
    shape = InputShape(f"{cfg.name}_rank_run", seq, k * batch, "train")
    with D.mesh_world(mesh):
        prog = D.build_train(cfg, shape, mesh, "asa16",
                             "bsp" if algo == "bsp" else "zero1",
                             optimizer=optimizer, lr_fn=lr_fn,
                             sharded_update=algo == "bsp")
        return D.analyze_program(prog, 0.0)


def _staging_items(colls: dict, k: int = 2) -> dict:
    """The gloo transport's staging copies of a step, kind by kind, from
    its collectives (``Transport._run``): every collective's input copied
    to the host and its output back, each counted on the card's side; an
    all-gather's input is 1/k of its output, an all-reduce's input and
    output are the bytes it counts (twice the result)."""
    n, b = colls["counts"], colls["bytes_by_kind"]
    factor = {"all-to-all": 2.0, "all-gather": 1.0 + 1.0 / k,
              "all-reduce": 1.0, "reduce-scatter": 1.0 + k}
    return {kind: dict(count=n[kind], device_bytes=factor[kind] * b[kind])
            for kind in n}


def dryrun_lm(lm_ranks):
    """(a) Phase 6's LM run (llama3.2-1b at LM_LAYERS, LM_BATCH x LM_SEQ
    tokens a rank, asa16 sharded, k = 2) dry-run at mesh data=2, against
    the first step that phase 6 counted on the card (rank 0's
    ``train/step`` profile): flops, the kernels' costs and the collectives
    by kind equal; the card's copies across host and card are the gloo
    staging that the collectives predict (listed kind by kind), to the
    byte, and LM_STEP_SCALAR_COPIES, by name and count; HBM bytes equal
    once all those copies are taken out; the
    predicted peak within DRYRUN_PEAK_TOL of each rank's
    max_memory_allocated."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.optim import sgd_momentum, warmup_cosine
    cfg = get_config("llama3.2-1b").with_overrides(num_layers=LM_LAYERS)
    t0 = time.perf_counter()
    dry = _dry_train(cfg, LM_BATCH, LM_SEQ, "bsp", LM_STEPS, sgd_momentum(
        momentum=0.9, weight_decay=1e-4, fused_kernel=fs.fused_sgd),
        warmup_cosine(0.01, 2, LM_STEPS))
    wall = time.perf_counter() - t0
    r0 = lm_ranks[0]
    real = r0["attribution"]["programs"]["train/step"]
    if not (real and real["captured"]):
        _fail(f"17(a): phase 6's train/step was not counted: {real}")
    colls = {kind: {n: float(v) for n, v in d.items()}
             for kind, d in dry["collectives"].items()}
    real_colls = {kind: {n: float(v) for n, v in d.items()}
                  for kind, d in real["collectives"].items()}
    staging = _staging_items(dry["collectives"])
    staged = sum(v["device_bytes"] for v in staging.values())
    real_hbm = real["hbm_bytes"] - real["host_copy_bytes"]
    copies = real["host_copies"]
    scalar = {n: c for n, c in copies.items()
              if not n.startswith("aten.copy_ ")}
    card_staged = sum(c["bytes"] for n, c in copies.items()
                      if n not in scalar)
    peaks = [rk["main"]["peak_mem_gb"] * 1e9 for rk in lm_ranks]
    pred = dry["memory"]["peak_bytes"]
    print(f"phase 17(a) llama3.2-1b at {LM_LAYERS} layers, {LM_BATCH} x "
          f"{LM_SEQ} tokens a rank, asa16 sharded, mesh data=2 ({wall:.1f}s;"
          f" {DRYRUN_LABEL}) against phase 6's counted first step on the "
          f"card: " + json.dumps(dict(
              flops=[dry["roofline"]["flops"], real["flops"]],
              collectives=[colls, real_colls],
              hbm_bytes=dict(dry=dry["roofline"]["hbm_bytes"],
                             card=real["hbm_bytes"],
                             card_host_copies=real["host_copy_bytes"],
                             card_less_host_copies=real_hbm),
              staging_items=staging, staging_device_bytes=staged,
              card_staging_device_bytes=card_staged,
              card_scalar_copies=scalar,
              transport_staged_bytes_a_step=r0["main"][
                  "staged_mb_per_step"] * 1e6,
              memory=dry["memory"], measured_peak_bytes=peaks,
              predicted_over_measured=[pred / p for p in peaks])))
    if dry["roofline"]["flops"] != real["flops"]:
        _fail(f"17(a): the dry run counts {dry['roofline']['flops']} flops, "
              f"the card's step {real['flops']}")
    if colls != real_colls:
        _fail(f"17(a): collectives {colls} != the card's {real_colls}")
    if dry["kernels"] != real["kernels"]:
        _fail(f"17(a): kernels {dry['kernels']} != the card's "
              f"{real['kernels']}")
    if card_staged != staged:
        _fail(f"17(a): the card's step stages {card_staged} bytes across "
              f"host and card, its collectives' staging {staged}: {copies}")
    if {n: c["count"] for n, c in scalar.items()} != LM_STEP_SCALAR_COPIES:
        _fail(f"17(a): the card's step makes the copies {scalar} beside its "
              f"staging, not {LM_STEP_SCALAR_COPIES}")
    if dry["roofline"]["hbm_bytes"] != real_hbm:
        card_ops = r0["attribution"].get("step_bytes_by_op") or {}
        diff = {op: (card_ops.get(op, 0.0), dry["bytes_by_op"].get(op, 0.0))
                for op in set(card_ops) | set(dry["bytes_by_op"])
                if card_ops.get(op, 0.0) != dry["bytes_by_op"].get(op, 0.0)}
        _fail(f"17(a): HBM bytes {dry['roofline']['hbm_bytes']} != the "
              f"card's {real_hbm} without its host copies; (card, dry) by "
              f"op where they differ: {diff}")
    bad = [p for p in peaks if not abs(pred / p - 1) <= DRYRUN_PEAK_TOL]
    if bad:
        _fail(f"17(a): predicted peak {pred} vs measured {peaks}")


def dryrun_archs():
    """(b) Phase 16(c)'s runs (ARCHS_MEASURED: each at its depth, batch and
    recipe) dry-run at mesh data=2: the predicted peak a rank printed
    beside the measured ones and the reckoning, and held to the measured
    within DRYRUN_PEAK_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import recipe
    if set(ARCHS_MEASURED) != {a for a, _ in ARCHS_TRAIN}:
        _fail(f"17(b) needs phase 16(c)'s runs, got {sorted(ARCHS_MEASURED)}")
    out = {}
    for arch, algo in ARCHS_TRAIN:
        m = ARCHS_MEASURED[arch]
        cfg = get_config(arch).with_overrides(num_layers=m["layers"])
        batch, seq, steps = ARCHS_RUN[algo]
        opt, lr = recipe(cfg, steps)
        t0 = time.perf_counter()
        dry = _dry_train(cfg, batch, seq, algo, steps, opt, lr)
        pred = dry["memory"]["peak_bytes"]
        peaks = [p * 1e9 for p in m["peaks"]]
        out[arch] = dict(algo=algo, layers=m["layers"],
                         predicted_peak_bytes=pred, memory=dry["memory"],
                         measured_peak_bytes=peaks,
                         reckoning_bytes=m["reckoning"],
                         predicted_over_measured=[pred / p for p in peaks],
                         reckoning_over_measured=[m["reckoning"] / p
                                                  for p in peaks],
                         dry_run_s=time.perf_counter() - t0)
    print(f"phase 17(b) phase 16(c)'s runs at mesh data=2 ({DRYRUN_LABEL}) "
          f"against their measured peaks a rank and the reckoning: "
          + json.dumps(out))
    bad = {a: r["predicted_over_measured"] for a, r in out.items()
           if not all(abs(x - 1) <= DRYRUN_PEAK_TOL
                      for x in r["predicted_over_measured"])}
    if bad:
        _fail(f"17(b): predicted peaks off by more than {DRYRUN_PEAK_TOL}: "
              f"{bad}")


def dryrun_row():
    """(c) One production row: DRYRUN_ROW on the 16 x 16 mesh (the fsdp
    mode with the model axis), which must be ok; its memory, collectives
    and roofline printed."""
    from repro_torch.launch import dryrun as D
    arch, shape = DRYRUN_ROW
    row = D.run_one(arch, shape, multi_pod=False)
    if not row["ok"]:
        _fail(f"17(c) {arch} {shape}: {row['error']}\n{row['traceback']}")
    row.pop("kernels", None)
    print(f"phase 17(c) {arch} {shape} on {row['mesh']} ({DRYRUN_LABEL}): "
          + json.dumps({key: row[key] for key in (
              "mode", "memory", "collectives", "collective_bytes_by_site",
              "roofline", "compile_s")}))
    if row["mode"] != "fsdp":
        _fail(f"17(c) {arch} {shape}: mode {row['mode']}, not fsdp")


def dryrun_main(lm_ranks):
    """Phase 17 from the main process, after phases 6 and 16(c) (their
    ranks' reports: ``lm_ranks``, ARCHS_MEASURED). No card is used: the
    dry run builds each program on meta tensors in a fake world of this
    process. Returns (kernel rows, {path: launches}): none."""
    import torch
    t0 = time.perf_counter()
    dryrun_lm(lm_ranks)
    dryrun_archs()
    dryrun_row()
    if torch.distributed.is_initialized():
        _fail("phase 17 left a process group initialised")
    print(f"phase 17 (dry run): {time.perf_counter() - t0:.1f}s")
    return [], {}


def kernels_line(rows, by_path):
    """The kernels line's entries: one a row, with the launches of the
    paths it stands for. A row at one path's shape counts that path's
    launches alone (at that shape, where it has a count_key); a row
    without paths counts the paths that no such row of its kernel claims,
    so no launch is counted in two rows."""
    claimed = {}
    for r in rows:
        claimed.setdefault(r["name"], set()).update(r.get("paths", ()))
    out = []
    for r in rows:
        b_ms, b_by = r["bound"]
        key = r.get("count_key", r["name"])
        paths = {p: c for p, c in by_path.items()
                 if (p in r["paths"] if "paths" in r
                     else p not in claimed[r["name"]])}
        out.append({"name": r["name"], "route": "cuda", "source": r["src"],
                    "replaces": r["replaces"],
                    "launches": sum(p.get(key, 0) for p in paths.values()),
                    "launches_by_path": {p: c[key] for p, c in paths.items()
                                         if c.get(key)},
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        if "rel_err" in r:
            out[-1]["max_rel_err"] = r["rel_err"]
        if "shape" in r:
            out[-1]["shape"] = r["shape"]
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # the port, and the CPU tests' JAX-free input makers (test_torch_ranks)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import models, serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import slot_gather as sg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    K.build_all()
    print(f"built {len(K.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f}s")
    if sys.argv[1:] == ["serve"]:        # phase 4's llama3.2-1b engine
        launches, _ = engine_phase(torch, K, cfg_mod.get_config(
            "llama3.2-1b"), models, serve, torch.device("cuda"))
        return finish(torch, card, [], {"serve": launches})
    if sys.argv[1:] == ["gspmd"]:        # phase 13 alone
        return finish(torch, card, *gspmd_main(torch, ref, fa))
    if sys.argv[1:] == ["encdec"]:       # phase 14 alone
        return finish(torch, card, *encdec_main(torch, ref, fa, K, models))
    if sys.argv[1:] == ["roofline"]:     # phase 15 alone
        return finish(torch, card, *roofline_main(
            torch, ref, fa, sg, K, models, serve, cfg_mod, card))
    if sys.argv[1:] == ["archs"]:        # phase 16 alone
        return finish(torch, card, *archs_main(torch, ref, fa, sg, K, models,
                                               serve))
    if sys.argv[1:] == ["dryrun"]:       # phase 17 alone, after the runs
        _, _, lm_ranks = lm_train_phase()    # it holds to: 6 and 16(c)
        archs_train_phase()
        return finish(torch, card, *dryrun_main(lm_ranks))
    t_run, laps = time.perf_counter(), [time.perf_counter()]

    def lap(label):
        """Prints the wall time of the phases since the last lap."""
        now = time.perf_counter()
        print(f"wall time: {label} {now - laps[0]:.1f}s (script "
              f"{now - t_run:.1f}s after the build)")
        laps[0] = now
    hopper_build_report(K)
    decode_build_report(K)
    sampler_build_report(K)
    mla_build_report(K)
    mla_tc_build_report(K)

    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, ref, fa, sg, flush=l2.zero_)
    # the training kernels' equivalence: full fp32 (cuDNN's default TF32
    # would only touch the convolutions of the train phase)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_rows, int8_launches = train_kernel_phase(torch, ref, flush=l2.zero_)
    rows += train_rows
    rows += lm_kernel_phase(torch, ref, fa, flush=l2.zero_)
    del l2
    torch.cuda.empty_cache()
    lap("phases 2-3 and the kernel checks of 4 and 7")
    conv_precision(torch)
    llama = cfg_mod.get_config("llama3.2-1b")
    launches, stats = engine_phase(torch, K, llama, models, serve,
                                   torch.device("cuda"))
    torch.cuda.empty_cache()
    qwen = cfg_mod.get_config("qwen1.5-4b")
    qwen_launches, _ = engine_phase(
        torch, K, qwen.with_overrides(num_layers=QWEN_SERVE_LAYERS), models,
        serve, torch.device("cuda"), QWEN_LOGIT_TOL)
    torch.cuda.empty_cache()
    chaos_launches = chaos_phase(torch, K, llama, models, serve,
                                 torch.device("cuda"))
    torch.cuda.empty_cache()
    lap("phases 4 and 10 (the engines, chaos)")
    ds_rows, ds_launches = ds_phase(torch, ref, fa, K, models, serve,
                                    cfg_mod)
    rows += ds_rows
    ssm_rows, ssm_launches = ssm_phase(torch, ref, fa, K, models, serve,
                                       cfg_mod)
    rows += ssm_rows
    lap("phases 11 and 12")
    lm_grad_check(torch, llama, models, torch.device("cuda"))
    torch.cuda.empty_cache()
    lm_grad_check(torch, qwen.with_overrides(num_layers=QWEN_GRAD_LAYERS),
                  models, torch.device("cuda"))
    torch.cuda.empty_cache()
    # launches per kernel and main path (serving llama3.2-1b and
    # qwen1.5-4b, serve chaos, DeepSeek-V2-Lite's training and serving,
    # serving mamba2-1.3b and hymba-1.5b, the gradient checks of hymba-1.5b
    # and chameleon-34b, the convnets' training, LM training, the int8
    # round trip), each path counted from zero around its run
    by_path = {"serve": launches, "serve_qwen1.5-4b": qwen_launches,
               "serve_chaos": chaos_launches, **ds_launches, **ssm_launches}
    conv_shapes = {}
    lap("phase 4's gradient checks")
    for arch, (launches_, shapes_) in train_phase().items():
        by_path[f"{arch}_train"], conv_shapes[arch] = launches_, shapes_
    by_path["int8_roundtrip"] = int8_launches
    lap("phase 5")
    by_path["lm_train"], lm_buckets, lm_ranks = lm_train_phase()
    lap("phase 6")
    by_path.update(async_phase())
    lap("phase 8")
    elastic_launches, elastic_buckets = elastic_phase()
    by_path.update(elastic_launches)
    lap("phase 9")
    gspmd_rows, gspmd_launches = gspmd_main(torch, ref, fa)
    rows += gspmd_rows
    by_path.update(gspmd_launches)
    encdec_rows, encdec_launches = encdec_main(torch, ref, fa, K, models)
    rows += encdec_rows
    by_path.update(encdec_launches)
    lap("phases 13 and 14")
    # the kernels of every training path, held to their plain versions at
    # the shapes that path gave them (the overlap's fp32 accumulated
    # receives into fused_rs_update at the LM's and AlexNet's buckets)
    wire_check(torch, ref, lm_buckets, "LM", 1e-4, overlap_m=OVERLAP_MB)
    for arch, (buckets, sgd_shapes) in conv_shapes.items():
        wire_check(torch, ref, buckets, arch, 5e-4,
                   overlap_m=OVERLAP_MB if arch == "alexnet" else 0)
        sgd_check(torch, ref, sgd_shapes, arch)
        torch.cuda.empty_cache()
    # the elastic centre exchange's buckets at each k of its synced rounds
    for kk, buckets in elastic_buckets.items():
        wire_check(torch, ref, buckets, "alexnet elastic", 5e-4, k=kk)
        torch.cuda.empty_cache()
    lap("phase 7")
    _, roofline_launches = roofline_main(torch, ref, fa, sg, K, models,
                                         serve, cfg_mod, card, lm_ranks)
    by_path.update(roofline_launches)
    lap("phase 15")
    archs_rows, archs_launches = archs_main(torch, ref, fa, sg, K, models,
                                            serve)
    rows += archs_rows
    by_path.update(archs_launches)
    lap("phase 16")
    dryrun_main(lm_ranks)
    lap("phase 17")

    return finish(torch, card, rows, by_path)


def gspmd_main(torch, ref, fa):
    """Phase 13 from the main process: (a) and (b) on the spawned ranks,
    then (c) on this one. Returns (kernel rows, {path: launches})."""
    t0 = time.perf_counter()
    by_path, shapes = gspmd_phase()
    torch.cuda.empty_cache()
    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = gspmd_kernel_rows(torch, ref, fa, shapes, flush=l2.zero_)
    del l2
    torch.cuda.empty_cache()
    print(f"phase 13 (gspmd): {time.perf_counter() - t0:.1f}s")
    return rows, by_path


def finish(torch, card, rows, by_path) -> int:
    """The kernels line, the card, and the contract's last line."""
    out = kernels_line(rows, by_path)
    print("wrapper call incl. host dispatch, ms: " + json.dumps(
        {r["name"]: r["host_ms"] for r in rows}))
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
