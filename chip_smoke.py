#!/usr/bin/env python3
"""On-card check and measurement of the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (the numbers in PERF.md come from an H100) and the CUDA
toolkit's nvcc; imports nothing of JAX.  Phases, any failure of which exits
non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all at once) and print what ``-Xptxas -v`` reports
   (registers, shared memory, spills; per instantiation of the decode
   body) and the decode and verify plans at both model widths (kv heads
   and query rows per CTA, stages, shared memory, splits, CTAs), whose
   shared memory must be the kernel source's layout; then the plans of
   LLaMA2-7B (half cache), LLaMA2-13B, Yi-6B, Granite-3.0-2B, MiniCPM-2B
   and the attention layers of Qwen3-MoE-235B (G = 16), Jamba-v0.1 and
   Arctic (G = 7) at half and a quarter cache, J- and S-LRD, f32 and int8,
   W = 1, 5 and 9, the verify windows that one kv head per CTA cannot hold
   cut into parts of fewer positions (LLaMA2-13B f32 at W = 5 must cut).
2. Hold each kernel against its plain PyTorch version on the card at
   TinyLlama-1.1B widths and at LLaMA2-7B widths, J-LRD and S-LRD, with
   empty lanes, partial blocks and ragged per-lane offsets and lengths; the
   selection kernels also with count-0 entries and a block selected twice;
   the verify kernels at W = 1, 3 and 5 with ragged q_offsets, windows
   across a block boundary and windows shorter than W.  A full-width
   selection must give the dense kernels' bits, and so must a verify
   window of one token at q_offsets = lengths - 1, f32 and int8.  The
   contiguous ``elite_decode`` with lengths 0, 1, a partial tile, S and
   past S (S = 1000, not a multiple of the tile, and 1152) must give the
   bits of ``elite_decode_paged`` over the same rows as identity-table
   pages; ``rope_elite``'s one-tensor entry with positions [S] and [B, S]
   up to 4096, 32 and 4 heads of 2r = 16, a strided q slice, and the full
   RoPE at dh = 64 and 128, and its q-and-k entry (``rope_elite_qk``) with
   EliteKV's grouping at TinyLlama-1.1B (32/4, 2r = 16) and LLaMA2-7B
   (32/32, 2r = 32) widths, the full RoPE at dh = 64 and 128, a slice 8
   bytes into the row (the 8-byte accesses) and B·S = 1, to 2e-6 relative;
   the share of bitwise-equal outputs is printed beside the earlier
   one-tensor kernel's (one launch per tensor, one sincos per head) on the
   same cases and must not be lower.
   ``flash_prefill``'s two bodies at Sq = 1, 2, 8, 100, 256 and 1024 over
   Sk = Sq + 333 keys with ragged offsets and lengths and a kv_len = 0
   lane, two calls giving the same bits.  A lane's bits must not depend on
   the other lanes: one lane through ``elite_decode_paged``, ``_q8`` and
   ``elite_verify_paged`` beside short lanes, beside a 600-row lane and
   with a wider table, and through ``flash_prefill``'s decode body beside
   lanes of other kv_len and at a larger Sk, all equal bit for bit.
   At the other architectures' widths: every decode entry and both
   verify entries (W = 1, 3, 5, 9; LLaMA2-13B's windows cut) at LLaMA2-13B
   half cache (40 kv heads, G = 1, 2r = 64, d_c = 2560), MiniCPM-2B
   quarter cache (36 kv heads, 2r = 16, d_c = 512) and at a quarter cache
   Qwen3-MoE (4 kv heads of 16 queries, 2r = 32, d_c = 128), Jamba (8 of
   4, d_c = 256) and Arctic (8 of 7, d_c = 256), J- and S-LRD; a forced
   cut at LLaMA2-7B quarter cache giving the uncut call's bits;
   ``rope_elite_qk`` at 40/40 and 36/36 heads (full and elite), with
   Yi-6B's base 5e6, and at Qwen3-MoE (64/4, base 1e6), Jamba (32/8) and
   Arctic (56/8); ``flash_prefill`` at 40/40, 64/4, 32/8 and 56/8 heads
   of 128.
3. Serve TinyLlama-1.1B at full width (22 layers, d 2048, EliteKV r=8,
   d_ckv=64) with random weights from a seeded ``torch.Generator`` — not
   the reference's weights, since the card has no JAX.  Each run sets the
   launch counts to 0 before it and reads them after, and must launch its
   decode kernel 22 times per decode forward, ``flash_prefill`` 22 times per
   prefill forward and no other kernel:
   a. the f32 pool: a Poisson stream of 24 greedy requests through chunked
      prefill (``elite_decode_paged``), then a small one-shot run on a pool
      tight enough to preempt;
   b. the int8 pool with block-top-k sparse decode (k=4 plus the 2 newest
      blocks, watermark admission): 16 requests of 512–768 prompt tokens
      (``elite_decode_sparse_paged_q8``);
   c. 6 requests on the int8 pool, dense (``elite_decode_paged_q8``), and
      6 with f32 sparse decode (``elite_decode_sparse_paged``);
   Every EliteKV forward also rotates q and k together through
   ``rope_elite``: 1 launch per layer and forward (prefill, decode, draft,
   verify).
   e. greedy self-speculative decode: 12 requests on the f32 pool, plain,
      then k=4 with the full-rank draft, then k=4 with the draft truncated
      to rank 32; 6 requests on the int8 pool, plain, then k=4 rank 32.
      A speculative run launches the verify kernel 22 times per verify
      forward, the pool's decode kernel 22 times per draft forward and
      ``flash_prefill`` 22 times per prefill forward, nothing else; its
      streams must equal the plain run's, apart from near-ties (top-2
      margin of the plain logits under 1e-3, recomputed by a one-shot
      prefill and printed) that f32 rounding decides; the full-rank draft
      must accept >= 99% of its proposals.
   f. lockstep ``generate`` over a contiguous cache, 8 prompts of 1024
      tokens and 128 new tokens each, EliteKV (``elite_decode`` 22 x 127,
      ``flash_prefill`` 22, ``rope_elite`` 22 x 128, nothing else) and the
      baseline GQA model (``flash_prefill`` 22 x 128, ``rope_elite``
      22 x 128): tok/s, step ms and the measured cache, which must equal
      the per-token formula; the EliteKV tokens must equal
      ``generate_paged``'s on the same prompts, apart from near-ties.
   g. sampled serving (temperature 0.8, top_p 0.95, a seed per request),
      12 f32 requests: undisturbed, its greedy twin (the sampler's cost), on
      a 160-block pool with recompute and with swap eviction, and k=4
      speculation with the full-rank draft (acceptance >= 99%).  Each
      sampled run keeps the logits row of every draw: up to where a stream
      parts from the undisturbed one, every token's row must be within
      1e-4 (max abs) of the undisturbed row, and where it parts the two
      rows must differ by at least the draw's flip distance (the least
      move of the logits that may change it), else the run fails; the
      flip distances of all undisturbed draws are printed.  The swap run's
      greedy twin must give the greedy twin's streams apart from top-2
      near-ties (under 1e-3).  The prefix cache off and on over 16 requests
      behind one 256-token prefix, sampled (rows as above) and greedy
      (near-ties as above): equal streams, and the tokens prefilled drop
      by exactly the hit tokens.
      The int8 pool with partial sparse decode (k=4+2), preempt admission
      and swap eviction on a tight pool: it preempts, finishes, and the
      first sequence swapped comes back bit for bit (codes, scales,
      summaries).  Swap-out and swap-in of a 1024-token sequence are timed,
      and the sampler at [8, 32000].
   h. observability: a, g's swap run and g's sampled prefix-cache-on run
      again with the scheduler's tracer, a fresh metrics registry and the
      kernel tracer armed.  Each must give its untraced run's tokens bit
      for bit on every stream, one ``kernel`` span per launch (span count
      per name == the launch counts' delta), and a trace and metrics file
      that ``tools/check_trace.py`` passes (run as a subprocess; the files
      go to ``build/obs/``); a's trace is summarised by ``diagnose
      trace-summary``.  A torch.profiler window over 10 steady f32 decode
      steps with the kernel tracer armed holds each kernel's summed span
      time against the profiler's device time for it (spans must cover
      the kernels and exceed them by under 10 us per launch: the launch
      gate keeps the host's issue time out), and again with the gate's
      stream wait taken out, to show what it keeps out; the decode step's p50 traced
      against untraced is taken in turns on one scheduler (U T T U), with
      events per step and ring drops.
   p. the data-parallel router (runs after h, on a's model): the five
      scenarios of ``runtime/sharded_check.py`` (plain with swap and
      recompute eviction on a 32-block pool that preempts, a 64-token
      shared prefix with the prefix cache, the int8 pool, speculative k=2)
      and a sampled one (temperature 0.8, top-p 0.9, a seed per request),
      each over 8 requests (prompts 64-256 tokens, 32 new, two arrivals per
      step, 4 slots, blocks of 16) through one ``Scheduler`` and through
      ``Router`` with two replicas sharing the card.  Greedy streams must
      equal the single scheduler's but where its token is a near-tie
      (``compare_streams``; counted), sampled ones are held by
      ``compare_sampled``; the logits rows of the two runs are compared
      (the bitwise-equal share answers whether a lane's bits move with its
      neighbours); each replica's launches must be its own forwards'
      (``path_kernels`` of its report).  A traced plain router run must
      give the untraced router's tokens, one kernel span per launch, and a
      trace and metrics file that ``tools/check_trace.py`` passes (a
      subprocess; ``build/obs/router_plain.*``); so must the files of
      ``launch/serve.py --stream --dp 2 --trace`` run in a fresh process,
      where no kernel is loaded yet (``build/obs/router_cli.*``).
   q. tensor-parallel attention (runs after p, on a's model): the paged
      forwards (``models/lm.py``, ``mesh=``) at tp 1, 2 and 4 on a
      ``TPMesh`` whose shards all sit on the one card, in four pools of
      blocks of 16 (f32 and int8, each without and with block summaries):
      a prefill of 4 lanes of 64-256 prompt tokens, the longest resumed as
      a second chunk, then 32 dense decode steps and a verify window of 3
      (or, with summaries, 8 sparse steps, k = 4 + 2).  Every logits row at
      tp 2 and 4 must equal tp 1's bit for bit; each run's launches must be
      its forwards' (the attention kernels ``tp`` times per layer and
      forward, ``flash_prefill`` and ``rope_elite`` as at tp 1).  Printed:
      the pool's bytes per token globally and per device, the decode
      step's p50 (CUDA events) and the launches per tp, and
      ``elite_decode_paged`` at a shard's widths (nkv 2 and 1, as launched:
      the unsharded call's split ranges) against its plain version, timed
      with its bound beside the unsharded call of the same step.
   r. tensor-parallel serving (runs after q, on a's model): p's one-
      ``Scheduler`` runs served again through ``Scheduler(mesh=)`` on a
      ``TPMesh`` whose shards all sit on the one card — at tp 2 in every
      scenario of p, sampled included, at tp 4 in plain, int8 and spec —
      and p's plain and prefix router runs through ``Router(meshes=)`` at
      tp 2 x dp 2.  Each run must give p's streams (the router's,
      replica by replica), every greedy logits row and every sampled draw
      (its row and token) bit for bit, p's preemptions, prefill forwards
      and decode steps, and launches that are its forwards' with the
      attention entry ``tp`` times (``path_kernels``).  ``sharded_check``'s
      parity cases (decode at tp 2 and 4, verify and int8 decode at tp 2)
      must give the tp-1 call's bits.  ``launch/serve.py
      --stream --tp 2 --trace`` in a fresh process must pass
      ``tools/check_trace.py`` (``build/obs/tp_cli.*``).  Printed beside
      p's tp 1: tok/s, TTFT p50/p95, the decode step's p50 and the pool's
      bytes per token per device.
   s. the sharded steps (runs after r): TinyLlama-1.1B at full width and
      depth on the 16 x 16 mesh as rank 0 of a fake group of 256 (no data
      moves), placed by ``distributed/sharding.py``'s rules: S1
      ``train_4k``, S2 ``prefill_32k`` and S3 ``decode_32k`` (8 lanes a
      device, the cache sequence over "model": 2,048 of 32,768 rows a
      device), each held to the dry run's per-device peak (S3 within 0.1
      GiB), launches and ``CommDebugMode``'s counts, outputs finite; the
      kernels' ``local_map`` wrappers at S1's and S2's shard shapes against
      their plain versions; and one cache of S3's shard widths over all
      32,768 rows on the card cut into 16 sequence pieces, each attended by
      ``elite_decode`` with its log-sum-exp and merged (``ref.merge_lse``),
      against one unsharded call within TOL, each piece's log-sum-exp
      against the plain version and its output bitwise that of the call
      without it.
   i. conversion (the paper's §3): the baseline TinyLlama-1.1B of f,
      4 x 512 random calibration tokens, ``capture_attn_inputs`` and a
      greedy RoPElite search at r = 8 per layer (``rope_elite`` 22 times in
      the capture and 22 in the search, nothing else); layers 0 and 21
      searched again on the CPU, equal apart from float64 ties; greedy,
      uniform and contribution distances per layer (greedy <= both x 1.001
      on layer 0); conversion at d_ckv = 64 and at exact rank 448, whose
      logits (``apply_train`` and a paged prefill through the kernels)
      must equal the baseline with RoPE restricted to the elite sets
      within 1e-3; the d_ckv = 64 model serves 8 greedy requests through
      the ``Scheduler``, its streams equal to lockstep ``generate``'s apart
      from near-ties; the times of capture, search per layer and SVDs.
   k. training (runs after i, before j): the rotation's backward (the
      ``rope_elite`` kernel in its transpose mode, under
      ``torch.autograd``) against autograd through the plain version, at
      TinyLlama-1.1B widths with q a strided slice of its projection, at
      LLaMA2-13B half cache (row blocks) and for the baseline's full RoPE,
      bitwise share printed; a 2-layer full-width TinyLlama-1.1B EliteKV
      (B 2 x S 256): every leaf's gradient on the card against the port on
      the CPU, ``wk_e``'s not zero; i's converted model (d_ckv = 64)
      uptrained 4 AdamW steps at B 8 x S 512, lr 1e-5 constant, full remat
      (the rotation launched 44 times forward and 22 backward per step,
      nothing else; losses finite and falling; step ms, tokens/s, peak
      memory, model-FLOP share; the same run at lr 3e-4 printed,
      unchecked); 2 steps with a checkpoint at step 2 and a restart to 4,
      losses within 1e-4 relative of the uninterrupted run's (8 steps, a
      sweep at 1e-4 too and a checkpoint at 4 until the sharded steps of
      phase 3s took their time);
      the uptrained weights serving 8 x (256 + 64) greedy requests, the
      ``Scheduler``'s streams equal to ``generate``'s apart from near-ties.
   j. MiniCPM-2B with tied embeddings at full width (40 layers, 36/36
      heads of 64, vocab 122,880; EliteKV r = 8, d_ckv = 512; ~10 GiB of
      f32 weights): 6 greedy requests plain, then k = 4 speculation with
      the full-rank draft, streams equal apart from near-ties, kernels 40
      times per forward.
   l. MoE, Mamba and hybrid stacks at full width (after the narrow-model
      checks below; every earlier model freed, each of these freed before
      the next is made), each run's kernels launched once per attention
      layer and forward and nothing else:
      Qwen3-MoE-235B, 1 of its 94 layers (128 experts top-8, 64/4 heads of
      128, vocab 151,936; EliteKV r = 16, d_ckv = 128: 1,024 B of cache
      per token against 4,096; ~12 GB of f32 weights; 4 layers until the
      sharded steps of phase 3s took their time) serving 3a's 24
      requests through the paged ``Scheduler``, every token's logits row
      against ``generate`` of its request alone within LOGIT_TOL (a
      request is excused only where ``generate``'s routers came within
      1e-6 of another expert choice, ``tests/routing_margins.py``; a
      stream may part where rows agree only at a near-tie), one
      group-size sync per MoE layer and forward, and a profiler window;
      Jamba-v0.1, one whole period (7 Mamba layers, EliteKV attention at
      position 3 with r = 16, d_ckv = 256, 4 MoE layers of 16 experts
      top-2, 4 MLPs; 53.2 GB) through ``generate`` at 8 x (1024 + 128),
      then cache on == cache off (prefill + decode logits against
      ``apply_train`` within LOGIT_TOL) and a profiler window;
      Falcon-Mamba-7B at full width, 16 of its 64 layers (cut in depth
      to keep the script inside its time), through ``generate`` at
      8 x (1024 + 128), launching no kernel.  Card against CPU on the same
      weights: one Qwen3-MoE and one Jamba MoE FFN on 64 tokens, one Mamba
      layer's prefill output and state and 16 decode steps (1e-5 of the
      largest magnitude); ``elite_decode_paged`` and ``flash_prefill`` at
      Qwen3-MoE's recorded inputs and ``elite_decode`` and
      ``flash_prefill`` at Jamba's, timed with their bounds (and SDPA's
      time: over prebuilt operands for ``elite_decode``, as phase 4).
   m. the vision and audio frontends at full width and depth, from the
      reference's batch inputs (after l, each model freed before the
      next): InternVL2-2B (24 layers, 16/8 heads of 128, vocab 92,672) and
      MusicGen-large (12 of its 48 layers, cut in depth to make room for
      phase 3s; 32/32 heads of 64, frames in, no embedding table), each a
      seeded baseline converted at
      ``pick_dims(cfg, 0.25, align=16)`` (r 16, d_ckv 256; r 8, d_ckv 512)
      by ``ropelite.search_model`` and ``convert.convert_model`` on a
      calibration batch (4 x (256 patch embeddings + 256 tokens); 2 x 512
      frames; ``rope_elite`` twice per layer, nothing else).  InternVL2: 8
      lanes of 256 patches + 256 tokens through ``apply_prefill_paged``,
      64 greedy steps of ``apply_decode_paged`` (its kernels once per
      layer and forward, nothing else), every logits row against
      ``apply_train`` over the whole sequence within 1e-4; 8 text
      requests through the ``Scheduler`` against ``generate``
      (``compare_greedy_rows``); 4 uptraining steps (f32 moments) at B 2 x
      (256 + 256), the rotation 2 x 24 forward and 24 backward per step;
      the converted model's first 2 layers' gradients on the card against
      the CPU.  MusicGen: 4 x 512 frames prefilled into the pool and 32
      decode steps of seeded frames, every row against ``apply_train``
      within 1e-4; one training step on frames and labels (int8 moments:
      f32 ones would not fit the functional update beside 3.0 B weights).
      ``elite_decode_paged`` and ``flash_prefill`` at each model's
      recorded inputs, held to their plain versions, then timed.
   n. training and conversion of MoE, Mamba and hybrid stacks at full
      width (after m, each model freed before the next; every conversion
      searches through the dense MoE oracle): (a) Qwen3-MoE-235B at 1 of
      94 layers converted on 4 x 512 tokens (r 16, d_ckv 128), its loss
      and backward at B 1 x 512 through ``ragged`` and ``dense`` (the
      rotation 2 forward and 1 backward launch per attention layer, 2
      group-size syncs per step under the layer remat), gradients within
      1e-4 of each leaf's largest unless a router gap is under 1e-6, and
      the functional AdamW's reckoning that rules the whole step out; (b)
      Qwen3-MoE at 1 layer converted, ``generate`` 8 x (512 + 32), every
      lane's every logits row against ``apply_train`` over the prompt and
      generated tokens within 1e-4 (cache on == off; routing excused as
      above); (c) one Jamba-v0.1 period converted (search and J-LRD at
      its attention layer 3, Mamba layers passed through), ``generate`` 8
      x (1024 + 128) with rows held the same way, then its layers 0-3
      through the loss and backward at B 1 x 512; (d) Falcon-Mamba-7B at 8
      of 64 layers, 2 AdamW steps (f32 moments) at B 8 x 512 (no kernel
      runs), and one layer's loss and backward with the scan's per-chunk
      recompute and with ``ssm_unroll``: peaks printed, gradients equal
      bit for bit but the embedding table's (an accumulating index_put,
      1e-6 of its largest); (e) one whole ``make_train_step`` (int8
      moments, ragged) of reduced Qwen3-MoE and Jamba on the card against
      the CPU, weights whose gradient is at least 1e-4 within 1e-5 of a
      leaf's largest, the others within 2·lr; (b) and (c)'s rows: a stack
      with Mamba layers is held to the reference's recurrence-against-scan
      tolerance, 2e-4 + 2e-4·|want|; (f) the rotation's backward at
      (a)'s and (c)'s recorded training inputs against its plain version,
      timed with its bound (PERF.md rows 9q, 9j).
   o. the dry run against the card (runs after phase 2, before a, on a
      card that holds next to nothing): ``launch/dryrun.py``'s targets
      (132 SMs, 227 KiB opt-in shared memory) must be the card's; for
      each cell ``dryrun.lower_cell`` on a 1 x 1 plan predicts the peak,
      temp and resident bytes and the FLOPs from a meta-device trace, then
      the same step (``dryrun.run_step`` on ``dryrun.cell_state`` of the
      same cell, seeded random weights) runs on the card after
      ``torch.cuda.reset_peak_memory_stats()``: ``max_memory_allocated()``
      less what the card held before the cell's tensors were made must be
      within max(3%, 256 MiB) of the prediction, the kernels' launches
      must be the trace's meta calls, and the outputs finite.  C1
      TinyLlama-1.1B EliteKV ``decode_32k`` at B 128 (a zeroed 32,768-row
      cache, index 32,767: ``elite_decode`` and ``rope_elite`` 22 each);
      C2 ``prefill_32k`` at the largest B <= 32 whose predicted peak, with
      what is held, is at most 90% of the card's memory (``flash_prefill``
      and ``rope_elite`` 22 each); C3 one AdamW step (f32 moments) at B 8
      x 512 (``rope_elite`` 44, ``rope_elite_backward`` 22); C4
      Qwen3-MoE-235B at 1 of 94 layers, its loss and gradients at B 1 x
      512 (ragged routing on the card, even groups on meta).  Meanwhile a
      subprocess without the card lists the dry run of every applicable
      cell at 16 x 16 (resident GiB per device, wall s).
   Every kernel is re-run on the busiest inputs recorded from its run and
   held against its plain version, twice, with identical bits; a torch.profiler window over 10 steady
   decode steps of 8 lanes, on the f32 pool, on the int8 pool with sparse
   decode, and as speculative macro-steps (k=4, full-rank draft) on the f32
   pool, gives the card's busy share and its time by kernel; a
   narrow model on the card must give
   the CPU's tokens on the f32 pool and on the int8 pool with sparse decode,
   with speculative decode (k=2, rank-16 draft) on both pools, through
   ``generate``, EliteKV and baseline, and sampled requests behind a shared
   prefix with the prefix cache on and swap eviction on a tight pool.
4. Time each kernel at its recorded main-path inputs (CUDA events, warm-up,
   L2 flushed before every launch), its plain version, its bound, and the
   PyTorch call that computes the same function where one exists, with the
   plan of each decode and verify call; and, on
   the int8 sparse run's busiest step, the dense kernels over the same
   lanes beside the pool's bytes per token, f32 against int8; and a W = 5
   verify call against the five decode calls that score the same window
   one token at a time.  ``rope_elite_qk`` is timed at four recorded
   inputs, ``generate``'s prefill and decode q and k, EliteKV and baseline
   (full RoPE), beside two launches of the one-tensor entry on the same
   inputs, its bound, launches and plain time; its backward (transpose)
   mode at the uptraining step's gradient shapes and strides.
   ``flash_prefill`` is timed at three recorded inputs: the f32 run's
   busiest prefill chunk, ``generate``'s 8 x 1024 prefill and the
   baseline's busiest decode call (one query row per lane), each beside
   its bound, launches, plain time and SDPA's time.  The inputs of this
   phase's decode, verify, ``flash_prefill`` and ``rope_elite_qk`` calls
   are saved to
   ``build/phase4_inputs.pt``, where ``kernel_turns.py`` times other trees'
   entry points on them.

Output ends with the card's name and power limit, a ``{"kernels": [...]}``
line, and ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))      # sampling_margins, conversion_checks

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores (the kernels use plain f32 FMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3      # TF32 tensor cores, three products per f32 one
PHASE4_INPUTS = ROOT / "build" / "phase4_inputs.pt"
TOL = 5e-5                   # f32, same math in another summation order
NEAR_TIE = 1e-3              # top-2 margin under which f32 rounding may decide
# max |logits difference| of two runs' rows for the same request and token
# (the same context through other forwards: another batch, a recompute
# prefill, a verify window, shared prefix blocks); a sampled stream may
# part only where its rows differ by no more than this
LOGIT_TOL = 1e-4
FLIP_SLACK = 2 * 2.0 ** -23  # f32 rounding of the scaled logits, times max |logit|
NUM_LAYERS = 22
DECODES = ("elite_decode_paged", "elite_decode_paged_q8", "elite_decode_sparse_paged",
           "elite_decode_sparse_paged_q8")
VERIFIES = ("elite_verify_paged", "elite_verify_paged_q8")
ROPE_ATOL, ROPE_RTOL = 1e-6, 2e-6   # one rotation per pair, no reduction
# flash_prefill's three main-path shapes at TinyLlama-1.1B widths, (B, Sq, Sk,
# nh, nkv): a paged prefill chunk, generate's prefill, the baseline's decode
FLASH_SHAPES = {"paged chunk": (8, 256, 768, 32, 4), "generate prefill": (8, 1024, 1024, 32, 4),
                "baseline decode": (8, 1, 1152, 32, 4)}
# flash_prefill's times at the recorded inputs with PR 11's body (H100 80GB
# HBM3, 700 W; PERF.md's kernel table), printed beside this run's
FLASH_EARLIER_MS = {"paged chunk": 0.190, "generate prefill": 1.588, "baseline decode": 0.2779}
# each decode and verify entry's time at its busiest call before the split-KV
# body (H100 80GB HBM3, 700 W; PERF.md's kernel table), printed beside this run's
EARLIER_MS = {"elite_decode": 0.494, "elite_decode_paged": 0.341,
              "elite_decode_paged_q8": 0.342, "elite_decode_sparse_paged": 0.050,
              "elite_decode_sparse_paged_q8": 0.056, "elite_verify_paged": 0.771,
              "elite_verify_paged_q8": 0.895}
# rope_elite's bitwise-equal share against its plain version with the
# earlier one-tensor kernel (one launch per tensor, one sincos per head; two
# launches for a pair): 100% on every phase 2 case and recorded input
# (kernel_turns.py on that kernel's tree, H100 80GB HBM3, 700 W; PERF.md)
ROPE_EARLIER_SAME = 1.0
# the dispatch entry a kernel's main-path calls go through, where the names differ
ENTRY = {"rope_elite": "rope_elite_qk"}
TPU_LINES = {"elite_decode": "src/repro/kernels/elite_decode.py:89",
             "rope_elite": "src/repro/kernels/rope_elite.py:35",
             "elite_decode_paged": "src/repro/kernels/elite_decode.py:193",
             "elite_decode_paged_q8": "src/repro/kernels/elite_decode.py:314",
             "elite_decode_sparse_paged": "src/repro/kernels/elite_decode.py:443",
             "elite_decode_sparse_paged_q8": "src/repro/kernels/elite_decode.py:559",
             "elite_verify_paged": "src/repro/kernels/elite_decode.py:689",
             "elite_verify_paged_q8": "src/repro/kernels/elite_decode.py:816"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def plan_line(p) -> str:
    return (f"plan: {p.ctas} CTAs = lanes x {p.groups} head groups x {p.splits} splits of "
            f"{p.tiles_per_split} tiles, {p.heads} kv heads per CTA, {p.stages} stages, "
            f"{p.smem} B shared memory per CTA")


def ptxas_summary(text: str):
    """[(instantiation, registers, spill line)] from nvcc's ``-Xptxas -v``
    report: each entry function's template arguments (page element, walk)
    where the mangled name shows them."""
    import re
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            walk = re.search(r"(Chain|Sel|Contig)Walk", name)
            flash = re.search(r"(flash_\w+_kernel)ILi(\d+)E", name)
            if "decode_kernel" in name and walk:
                elem = "int8" if name.split("decode_kernel")[1].startswith("Ia") else "f32"
                name = f"decode_kernel<{elem}, {walk.group(0)}>"
            elif flash:
                name = f"{flash.group(1)}<dh={flash.group(2)}>"
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append((name, int(m.group(1)), spills))
                name = None
    return out


def time_ms(fn, iters: int = 30, warmup: int = 3, flush=None, ahead: bool = True) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each timed by its
    own CUDA events after ``flush`` evicts the L2.  A 0.2 ms device sleep
    sits between the flush and the start event, so the host has queued
    ``fn``'s launches before the card reaches the event: a wrapper's Python
    checks (~50 µs) are not counted as device time, unless ``fn`` takes the
    host longer than the sleep to queue, as a plain version of many small
    ops may.  ``ahead=False`` leaves the sleep out, to show how much host
    time a measurement without it counts."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        if ahead:
            torch.cuda._sleep(400_000)       # ~0.2 ms at the H100's ~1.98 GHz
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


# The bytes and FLOPs of a kernel call (the bounds) are the kernel modules'
# own formulas, which the dry run's meta versions count too:
# ``elite_decode.decode_cost``/``contig_decode_cost`` (with ``split_decode``,
# ``visited_rows``, ``scored_pairs``), ``flash_prefill.prefill_cost`` and
# ``rope_elite.rope_cost``; the functions below import them.


def rope_two_launches(a, plain=False):
    """q and k rotated as the callers did before the q-and-k entry, by two
    launches of the one-tensor entry (or its plain version), each frequency
    row repeated for the heads that read it (broadcast, head stride 0, for
    one row)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rope_elite as re_k
    q, k, pos, freqs = a[:4]
    rows = lambda heads: (freqs.expand(heads, -1) if freqs.shape[0] == 1
                          else freqs.repeat_interleave(heads // freqs.shape[0], 0))
    fn = ref.rope_elite_ref if plain else re_k.rope_elite
    return fn(q, pos, rows(q.shape[2])), fn(k, pos, rows(k.shape[2]))


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_decode(dev, nh, nkv, r2, dc, separate, seed, bs=16, mb=64):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 15, 16, 300, 777, mb * bs, 0]     # empty, partial, full
    B, n_blocks = len(lengths), len(lengths) * mb
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(n_blocks * bs, dc)
    x = dict(q_e=f(B, nh, r2), q_lat=f(B, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=c_k, c_v=f(n_blocks * bs, dc) if separate else c_k, bs=bs)
    perm = torch.randperm(n_blocks, generator=g, device=dev).int()
    bt = torch.zeros((B, mb), dtype=torch.int32, device=dev)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-L // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    x["bt"], x["lengths"] = bt, torch.tensor(lengths, dtype=torch.int32, device=dev)
    return x


def random_selection(x, W: int, seed: int):
    """Sorted random picks of up to W of each lane's blocks with their row
    counts, count-0 padding at block 0, and lane 5 picking one physical block
    twice → (sel_tables, sel_counts) [B, W] int32."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    bt, bs = x["bt"].cpu(), x["bs"]
    st = torch.zeros((bt.shape[0], W), dtype=torch.int32)
    ct = torch.zeros_like(st)
    for b, L in enumerate(x["lengths"].tolist()):
        n = -(-L // bs)
        pick = torch.sort(torch.randperm(n, generator=g)[:W])[0]
        st[b, :len(pick)] = bt[b, pick]
        ct[b, :len(pick)] = (L - pick * bs).clamp(0, bs).int()
    st[5, 1], ct[5, 1] = st[5, 0], ct[5, 0]
    dev = x["bt"].device
    return st.to(dev), ct.to(dev)


def random_verify(dev, nh, nkv, r2, dc, separate, W, seed, bs=16, mb=64):
    """Lanes with windows (q_offset, n tokens, n <= W): two dead lanes, a
    window at position 0, windows across a block boundary, a short one (pad
    rows), ragged ones, and one that ends the table."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    windows = [(0, 0), (0, W), (bs - 2, W), (bs * 5 - 1, max(1, W - 2)), (300, W),
               (777, W), (mb * bs - W, W), (0, 0)]
    B, n_blocks = len(windows), len(windows) * mb
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(n_blocks * bs, dc)
    x = dict(q_e=f(B, W, nh, r2), q_lat=f(B, W, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=c_k, c_v=f(n_blocks * bs, dc) if separate else c_k, bs=bs)
    perm = torch.randperm(n_blocks, generator=g, device=dev).int()
    bt = torch.zeros((B, mb), dtype=torch.int32, device=dev)
    used = 0
    for b, (off, n) in enumerate(windows):
        k = -(-(off + n) // bs) if n else 0
        bt[b, :k] = perm[used:used + k]
        used += k
    i32 = dict(dtype=torch.int32, device=dev)
    x["bt"] = bt
    x["offs"] = torch.tensor([o for o, _ in windows], **i32)
    x["lengths"] = torch.tensor([o + n if n else 0 for o, n in windows], **i32)
    return x


def quantized_pages(x):
    """x's pages as int8 plus per-slot scales (J-LRD: one latent, one scale)."""
    from repro_torch.core import quant
    (k, ks), (ck, cks) = quant.quantize_rows(x["k_e"]), quant.quantize_rows(x["c_k"])
    cv, cvs = (ck, cks) if x["c_v"] is x["c_k"] else quant.quantize_rows(x["c_v"])
    return (k, ck, cv, ks, cks, cvs)


def decode_call(name: str, x, dh: int, sel=None):
    """The argument tuple of ``name`` on the random case ``x``."""
    pages = quantized_pages(x) if name.endswith("q8") else (x["k_e"], x["c_k"], x["c_v"])
    walk = sel if "sparse" in name else (x["bt"], x["lengths"])
    if "verify" in name:
        walk = (x["bt"], x["offs"], x["lengths"])
    G = x["q_e"].shape[-2] // x["k_e"].shape[1]
    return (x["q_e"], x["q_lat"], *pages, *walk, G, dh ** -0.5, x["bs"])


def random_contig(dev, nh, nkv, r2, dc, separate, S, seed):
    """A contiguous cache of S rows per lane; lengths 0, 1, a partial tile,
    S - 5, S and past S."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 13, 17, S - 5, S, S + 9, 0]
    B = len(lengths)
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(B, S, dc)
    return (f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), c_k,
            f(B, S, dc) if separate else c_k,
            torch.tensor(lengths, dtype=torch.int32, device=dev), nh // nkv)


def as_identity_pages(a, bs: int = 16):
    """``elite_decode``'s arguments as ``elite_decode_paged``'s: each lane's
    rows padded to whole blocks, the identity block table, lengths clamped
    to S."""
    import torch
    q_e, q_lat, k_e, c_k, c_v, lengths, G, scale = a
    B, S = k_e.shape[:2]
    mb = -(-S // bs)
    pad = lambda t: torch.cat([t, t.new_zeros((B, mb * bs - S) + t.shape[2:])], 1) \
        .reshape((B * mb * bs,) + t.shape[2:])
    ck = pad(c_k)
    table = torch.arange(B * mb, dtype=torch.int32, device=k_e.device).reshape(B, mb)
    return (q_e, q_lat, pad(k_e), ck, ck if c_v is c_k else pad(c_v), table,
            lengths.clamp(max=S), G, scale, bs)


def rope_cases(dev, seed):
    """{label: (x, positions, freqs)}: 32 and 4 heads of 2r = 16 with
    chunk 0 at frequency 1.0, a 2r slice of a 64-wide q, and the full RoPE
    at dh = 64 and 128; positions up to 4096, [S] int64 and [B, S] int32."""
    import torch
    from repro_torch.core import rope
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S = 4, 1000
    out = {}
    for label, H, width, wide in (("H=32 2r=16", 32, 16, 16), ("H=4 2r=16", 4, 16, 16),
                                  ("q slice 2r=16 of 64", 32, 16, 64),
                                  ("full dh=64", 4, 64, 64), ("full dh=128", 32, 128, 128)):
        if label.startswith("full"):
            freqs = rope.chunk_freqs(width, 10000.0, device=dev).expand(H, width // 2)
        else:
            freqs = torch.exp(-4 * torch.rand(H, width // 2, generator=g, device=dev))
            freqs[:, 0] = 1.0
        x = torch.randn(B, S, H, wide, generator=g, device=dev)[..., :width]
        out[label + " pos [S]"] = (x, torch.randint(0, 4097, (S,), generator=g,
                                                    device=dev), freqs)
        out[label + " pos [B,S]"] = (x, torch.randint(0, 4097, (B, S), generator=g,
                                                      device=dev).int(), freqs)
    return out


# rope_elite_qk's cases: (query heads, key heads, frequency rows, 2r,
# projection width, slice start): EliteKV at TinyLlama-1.1B and LLaMA2-7B
# widths, the full RoPE at dh 64 and 128, and a slice 8 bytes into the row
ROPE_PAIR_CASES = {"EliteKV 32/4 2r=16": (32, 4, 4, 16, 64, 0),
                   "EliteKV 32/32 2r=32": (32, 32, 32, 32, 128, 0),
                   "full dh=64 32/4": (32, 4, 1, 64, 64, 0),
                   "full dh=128 32/32": (32, 32, 1, 128, 128, 0),
                   "slice at 8 B 32/4 2r=16": (32, 4, 4, 16, 64, 2)}
# ... and at the other dense architectures' widths (one query head per
# frequency row for LLaMA2-13B and MiniCPM-2B), a last field the RoPE base
# where it is not 10,000: Yi-6B's 5e6, its elite rows drawn from that table
ARCH_ROPE_PAIR_CASES = {"EliteKV 40/40 2r=64": (40, 40, 40, 64, 128, 0),
                        "full dh=128 40/40": (40, 40, 1, 128, 128, 0),
                        "EliteKV 36/36 2r=16": (36, 36, 36, 16, 64, 0),
                        "full dh=64 36/36": (36, 36, 1, 64, 64, 0),
                        "Yi-6B EliteKV 32/4 2r=32 theta 5e6": (32, 4, 4, 32, 128, 0, 5e6),
                        "Yi-6B full dh=128 32/4 theta 5e6": (32, 4, 1, 128, 128, 0, 5e6),
                        "Qwen3-MoE EliteKV 64/4 2r=32 theta 1e6": (64, 4, 4, 32, 128, 0, 1e6),
                        "Qwen3-MoE full dh=128 64/4 theta 1e6": (64, 4, 1, 128, 128, 0, 1e6),
                        "Jamba EliteKV 32/8 2r=32": (32, 8, 8, 32, 128, 0),
                        "Arctic EliteKV 56/8 2r=32": (56, 8, 8, 32, 128, 0)}


def rope_pair_cases(dev, seed, cases=ROPE_PAIR_CASES):
    """{label: (q, k, positions, freqs, q_per_row, k_per_row)}: each of
    ``cases`` at B, S = 4, 1000 with positions [S] int64 and [B, S] int32
    up to 4096, and at B = S = 1; elite frequency rows with chunk 0 at 1.0
    (or, with a RoPE base given, distinct chunks of that base's table), the
    full RoPE's one ``chunk_freqs`` row."""
    import torch
    from repro_torch.core import rope
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for label, (Hq, Hk, rows, r2, wide, start, *base) in cases.items():
        theta = base[0] if base else 10000.0
        if rows == 1:
            freqs = rope.chunk_freqs(r2, theta, device=dev)[None]
        elif base:
            table = rope.chunk_freqs(wide, theta, device=dev)
            freqs = torch.stack([table[torch.randperm(wide // 2, generator=g, device=dev)[
                :r2 // 2]] for _ in range(rows)])
        else:
            freqs = torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=dev))
            freqs[:, 0] = 1.0
        for B, S, per_lane in ((4, 1000, False), (4, 1000, True), (1, 1, False)):
            q = torch.randn(B, S, Hq, wide + start, generator=g, device=dev)[
                ..., start:start + r2]
            k = torch.randn(B, S, Hk, r2, generator=g, device=dev)
            pos = torch.randint(0, 4097, (B, S) if per_lane else (S,), generator=g,
                                device=dev)
            tag = "B=S=1" if B * S == 1 else "pos [B,S]" if per_lane else "pos [S]"
            out[f"{label} {tag}"] = (q, k, pos.int() if per_lane else pos, freqs,
                                     Hq // rows, Hk // rows)
    return out


def rope_err(got, want):
    """(max abs error, elements outside atol + rtol·|want|, bitwise-equal share)."""
    import torch
    torch.cuda.synchronize()
    if isinstance(got, tuple):               # (q, k) of the pair entry
        got, want = (torch.cat([t.flatten() for t in x]) for x in (got, want))
    d = (got - want).abs()
    bad = int((d > ROPE_ATOL + ROPE_RTOL * want.abs()).sum())
    return float(d.max()), bad, float((got == want).float().mean())


def rope_check(label: str, got, want, card: str) -> float:
    """Print a rotation's error and bitwise-equal share beside the earlier
    kernel's (``ROPE_EARLIER_SAME``); raise on an element past the
    tolerance or a share below the earlier kernel's.  → max abs error."""
    e, bad, same = rope_err(got, want)
    print(f"[{card}] parity {label}: max_abs_err={e:.3e}, {bad} outside "
          f"{ROPE_ATOL:.0e} + {ROPE_RTOL:.0e}·|plain|, bitwise equal {100 * same:.2f}% "
          f"(earlier one-tensor kernel: {100 * ROPE_EARLIER_SAME:.2f}%)", flush=True)
    if bad:
        raise AssertionError(f"{label}: {bad} elements past the tolerance")
    if same < ROPE_EARLIER_SAME:
        raise AssertionError(f"{label}: bitwise-equal share {same} below the earlier "
                             f"kernel's {ROPE_EARLIER_SAME}")
    return e


def random_prefill(dev, nh, nkv, dh, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Sq, Sk = 4, 200, 713                 # neither a multiple of the tiles
    return dict(q=torch.randn(B, Sq, nh, dh, generator=g, device=dev),
                k=torch.randn(B, Sk, nkv, dh, generator=g, device=dev),
                v=torch.randn(B, Sk, nkv, dh, generator=g, device=dev),
                offs=torch.tensor([0, 300, 513, 0], dtype=torch.int32, device=dev),
                lens=torch.tensor([Sq, 450, 713, 0], dtype=torch.int32, device=dev),
                G=nh // nkv, scale=dh ** -0.5)


def flash_cases(dev, nh, nkv, dh, seed):
    """{label: inputs} with Sq of 1, 2, 8, 100, 256 and 1024 over Sk = Sq +
    333 keys (a multiple of no tile): per lane a fresh start, a resumed
    chunk, a kv_len that ends inside the chunk, kv_len = 0, and a random
    offset."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for Sq in (1, 2, 8, 100, 256, 1024):
        Sk, room = Sq + 333, 333
        extra = int(torch.randint(0, room + 1, (1,), generator=g, device=dev))
        offs = [0, room // 3, room, 0, extra]
        lens = [Sq, room // 3 + Sq, room + Sq // 2 + 1, 0, offs[4] + Sq]
        f = lambda *s: torch.randn(s, generator=g, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        out[f"Sq={Sq} Sk={Sk}"] = dict(
            q=f(5, Sq, nh, dh), k=f(5, Sk, nkv, dh), v=f(5, Sk, nkv, dh),
            offs=torch.tensor(offs, **i32), lens=torch.tensor(lens, **i32), G=nh // nkv,
            scale=dh ** -0.5)
    return out


def contig_sdpa_call(a):
    """The contiguous decode's SDPA yardstick: one call over the same
    scores with prebuilt [q_e | q_lat] and [K_e | C_k] (the latent broadcast
    to the kv heads), values C_v and a boolean length mask; only the call
    is timed, not the builds."""
    import torch
    import torch.nn.functional as F
    q_e, q_lat, k_e, c_k, c_v, lens, G, sc = a
    B, S = k_e.shape[:2]
    nkv, dc = k_e.shape[2], c_k.shape[-1]
    qs = torch.cat([q_e, q_lat], -1)[:, :, None]                      # [B,nh,1,2r+dc]
    ks = torch.cat([k_e.transpose(1, 2),
                    c_k[:, None].expand(B, nkv, S, dc)], -1).contiguous()
    vs = c_v[:, None].expand(B, nkv, S, dc).contiguous()
    lmask = (torch.arange(S, device=q_e.device)[None, :] < lens[:, None])[:, None, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=lmask, scale=sc,
                                                  enable_gqa=True)


def sdpa_call(x):
    """One ``scaled_dot_product_attention`` call that computes flash_prefill
    on x (boolean mask, ``enable_gqa``), its inputs built beforehand."""
    import torch
    import torch.nn.functional as F
    q, k, v, offs, lens = x["q"], x["k"], x["v"], x["offs"], x["lens"]
    dev = q.device
    kpos, qpos = torch.arange(k.shape[1], device=dev), torch.arange(q.shape[1], device=dev)
    mask = ((kpos[None, None, :] <= qpos[None, :, None] + offs[:, None, None])
            & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  scale=x["scale"], enable_gqa=True)


def lane_invariance(dev, card: str, wname: str, nh, nkv, r2, dc, dh) -> None:
    """A lane's bits must not depend on the other lanes: lane 0 (300 rows)
    decoded beside short lanes (a table of 19 blocks), beside a 600-row
    lane (38 blocks) and with the table padded to 80 blocks, through
    ``elite_decode_paged``, ``_q8`` and ``elite_verify_paged`` (W = 3); and
    one decode row through ``flash_prefill``'s decode body beside lanes of
    other kv_len and at a larger Sk."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.kernels import flash_prefill as fp
    g = torch.Generator(device=dev).manual_seed(60)
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    bs, n_blocks, G = 16, 200, nh // nkv
    k_e, c = f(n_blocks * bs, nkv, r2), f(n_blocks * bs, dc)
    (k8, ks), (c8, cs) = quant.quantize_rows(k_e), quant.quantize_rows(c)
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev).int() + 1
    q1, q3 = (f(8, nh, r2), f(8, nh, dc)), (f(8, 3, nh, r2), f(8, 3, nh, dc))
    outs = {n: [] for n in ("elite_decode_paged", "elite_decode_paged_q8", "elite_verify_paged")}
    for lengths, mb in (([300, 20, 5, 40, 17, 1, 0, 33], 19),
                        ([300, 20, 5, 600, 17, 1, 0, 33], 38),
                        ([300, 20, 5, 40, 17, 1, 0, 33], 80)):
        bt = torch.zeros((8, mb), dtype=torch.int32, device=dev)
        used = 0
        for b, L in enumerate(lengths):
            n = -(-L // bs)
            bt[b, :n] = perm[used:used + n]
            used += n
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        tail = (G, dh ** -0.5, bs)
        outs["elite_decode_paged"].append(ed.elite_decode_paged(*q1, k_e, c, c, bt, lens,
                                                                *tail)[0])
        outs["elite_decode_paged_q8"].append(ed.elite_decode_paged_q8(
            *q1, k8, c8, c8, ks, cs, cs, bt, lens, *tail)[0])
        outs["elite_verify_paged"].append(ed.elite_verify_paged(
            *q3, k_e, c, c, bt, (lens - 3).clamp(min=0), lens, *tail)[0])
    k, v, q = f(4, 1300, nkv, dh), f(4, 1300, nkv, dh), f(4, 1, nh, dh)
    outs["flash_prefill decode body"] = []
    for lengths, S in (([513, 20, 5, 90], 700), ([513, 700, 0, 600], 700),
                       ([513, 20, 5, 90], 1300)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        outs["flash_prefill decode body"].append(fp.flash_prefill(
            q, k[:, :S].contiguous(), v[:, :S].contiguous(), G, dh ** -0.5, lens - 1,
            lens)[0])
    torch.cuda.synchronize()
    for name, o in outs.items():
        if not (torch.equal(o[0], o[1]) and torch.equal(o[0], o[2])):
            raise AssertionError(f"{name} ({wname}): a lane's bits depend on the other "
                                 f"lanes or on the table's width")
    print(f"[{card}] lane bits independent of the other lanes and of the width, {wname}: "
          f"{', '.join(outs)}", flush=True)


def run_decode(name: str, a, plain=False):
    from repro_torch.kernels import elite_decode, ref
    fn = getattr(ref, name + "_ref") if plain else getattr(elite_decode, name)
    return fn(*a)


def run_prefill(x, plain=False):
    from repro_torch.kernels import flash_prefill, ref
    fn = ref.flash_prefill_ref if plain else flash_prefill.flash_prefill
    return fn(x["q"], x["k"], x["v"], x["G"], x["scale"], x["offs"], x["lens"])


def max_err(a, b) -> float:
    import torch
    torch.cuda.synchronize()
    return float((a - b).abs().max())


def check(name: str, err: float, card: str) -> float:
    print(f"[{card}] parity {name}: max_abs_err={err:.3e} tol={TOL:.0e}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"{name}: max abs err {err} > {TOL}")
    return err


def profile_decode(params, buffers, cfg, dev, card: str, label: str, steps: int = 10,
                   tracer=None, stats=None, **pool):
    """Device time by kernel and the card's busy share over ``steps`` steady
    decode steps of 8 lanes (prompts of 512 tokens, prefilled first) on a
    pool configured by ``pool`` (SchedulerConfig fields); a speculative
    config's step is one draft/verify macro-step.  With a ``tracer`` the
    scheduler records into it and the kernel tracer is armed for the
    window (the tracer holds only the window's events).  ``stats`` (a dict)
    gets the window's wall and busy ms, device events and MoE group-size
    syncs per step.
    → [(profiler key, device ms, count)] of the window's device rows."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve_loop
    scfg = serve_loop.SchedulerConfig(
        max_slots=8, block_size=16, num_blocks=512, max_new_tokens=64,
        max_len=1024, prefill_chunk_tokens=256, prefill_batch_lanes=8, **pool)
    rng = np.random.default_rng(2)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=dev, tracer=tracer)
    for i in range(8):
        sched.submit(serve_loop.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=64))
    for _ in range(3):                  # two 256-token chunks, then decoding
        sched.step()
    ops.set_kernel_tracer(tracer, device=dev)
    if tracer is not None:
        tracer.clear()
    try:
        kind = "macro-steps" if pool.get("speculate_k") else "decode steps"
        return profile_window(sched.step, steps, card, f"{label}: {steps} {kind} x 8 lanes",
                              stats)
    finally:
        ops.set_kernel_tracer(None)


def profile_window(step, steps: int, card: str, label: str, stats=None):
    """torch.profiler over ``steps`` calls of ``step()``: prints the wall
    time, the device's busy share, device events and MoE group-size syncs
    per step and the 8 busiest device rows; fills ``stats`` (a dict) with
    those numbers.  → [(profiler key, device ms, count)] of the device rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import moe
    torch.cuda.synchronize()
    syncs = moe.group_size_syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    syncs = moe.group_size_syncs - syncs
    # device-side events only (kernels, copies, sets): a CPU op's row repeats
    # the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    events = sum(c for *_, c in rows) / steps
    print(f"[{card}] profile {label}: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%, {events:.0f} device events per step"
          + (f", {syncs / steps:.1f} MoE group-size syncs per step" if syncs else ""))
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[{card}]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<6d} {key[:90]}")
    if stats is not None:
        stats.update(wall_ms=wall_ms / steps, busy_ms=busy_ms / steps, events=events,
                     syncs=syncs / steps)
    return rows


class Recorder:
    """Wraps the dispatch functions in ``core.elite_attention``'s ``ops`` to
    keep the arguments of every layer-0 call of a run (call ``i`` of a name
    is layer ``i % n_layers``), so the kernels can be re-run on real
    main-path inputs.  ``select_topk_blocks`` is recorded too: its tables
    and lengths are those of the sparse call of the same step."""

    NAMES = DECODES + VERIFIES + ("flash_prefill", "select_topk_blocks")

    def __init__(self, n_layers: int, names=NAMES):
        from repro_torch.core import elite_attention
        self.ops, self.n = elite_attention.ops, max(1, n_layers)
        self.orig = {k: getattr(self.ops, k) for k in names}
        self.calls = {k: [] for k in names}
        counts = dict.fromkeys(names, 0)

        def wrap(name):
            def fn(*a, **kw):
                if counts[name] % self.n == 0:
                    self.calls[name].append(a)
                counts[name] += 1
                return self.orig[name](*a, **kw)
            return fn

        for k in names:
            setattr(self.ops, k, wrap(k))

    def close(self):
        for k, fn in self.orig.items():
            setattr(self.ops, k, fn)


def path_kernels(scfg, rep, n_layers: int, tp: int = 1):
    """{kernel: launches} a run with this config must have made over
    ``n_layers`` attention layers: its decode kernel once per attention
    layer and decode forward (per draft forward, and the
    verify kernel per verify forward, when speculating), ``flash_prefill``
    once per layer and prefill forward, ``rope_elite`` once per layer and
    forward of any kind (q and k together).  At ``tp`` > 1 the decode and
    verify kernels launch once per head shard."""
    q8 = "_q8" if scfg.cache_dtype == "int8" else ""
    sparse = "sparse_" if scfg.sparse_topk_blocks else ""
    want = {"flash_prefill": rep.prefill_chunks,
            "rope_elite": rep.prefill_chunks + rep.decode_steps + rep.draft_forwards}
    if scfg.speculate_k:
        want["elite_verify_paged" + q8] = rep.decode_steps
        want["elite_decode_paged" + q8] = rep.draft_forwards
    else:
        want[f"elite_decode_{sparse}paged{q8}"] = rep.decode_steps
    return {k: v * n_layers * (1 if k in ("flash_prefill", "rope_elite") else tp)
            for k, v in want.items()}


def serve_run(label, params, buffers, cfg, scfg, reqs, card: str, setup=None, draws=None,
              tracer=None, metrics=None, mesh=None):
    """Serve ``reqs`` with the counts set to 0 just before and read just
    after; check outputs and that the path's kernels (``path_kernels``) ran
    once per attention layer and forward and nothing else launched.  ``setup(scheduler)``
    runs before the requests are served; ``draws`` (a dict) gets every
    sampled draw (``record_draws``).  With a ``tracer`` the scheduler
    records into it (and meters into ``metrics``) and the kernel tracer is
    armed for the run.  ``mesh`` (a ``TPMesh``) serves tensor-parallel.
    → (report, launches, recorder, scheduler)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    L = cfg.n_attn_layers
    rec = Recorder(L)
    dev = lm.params_device(params)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=dev, tracer=tracer,
                                 metrics=metrics, mesh=mesh)
    if setup is not None:
        setup(sched)
    undo = record_draws(draws) if draws is not None else (lambda: None)
    ops.reset_launches()
    ops.set_kernel_tracer(tracer, device=dev)
    try:
        rep = sched.run(reqs)
        torch.cuda.synchronize()
        launches = ops.launches()
    finally:
        ops.set_kernel_tracer(None)
        rec.close()
        undo()
    print(f"[{card}] {label}: {rep.summary()}", flush=True)
    print(f"[{card}] {label} phases: {rep.phase_table()}")
    fwd = (f"{rep.draft_forwards} draft + {rep.decode_steps} verify" if scfg.speculate_k
           else f"{rep.decode_steps} decode")
    print(f"{label} launches: { {k: v for k, v in launches.items() if v} } over {fwd} "
          f"and {rep.prefill_chunks} prefill forwards x {L} attention layers")
    if rep.completed != len(reqs):
        raise AssertionError(f"{label}: {rep.completed}/{len(reqs)} requests finished")
    for r in sched.finished:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label} request {r.uid}: bad output {toks[:8]}...")
    want = path_kernels(scfg, rep, L, 1 if mesh is None else mesh.tp)
    for name, n in want.items():
        if not launches[name] == n > 0:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                 f"expected {n} (forwards x layers)")
    others = {k: v for k, v in launches.items() if k not in want and v}
    if others:
        raise AssertionError(f"{label}: other kernels launched: {others}")
    return rep, launches, rec, sched


# a profiler row's kernel → its launch counter in the f32 dense decode
# window (checked in this order: "flash_decode_kernel" is flash_prefill's)
PROFILED = (("rope_qk_kernel", "rope_elite"), ("flash_", "flash_prefill"),
            ("decode_kernel", "elite_decode_paged"))


def spans_vs_profiler(rows, events) -> dict:
    """{launch counter: (span ms, spans, profiler device ms, profiled
    launches)} for a window's profiler rows and its tracer's events."""
    prof, spans = {}, {}
    for key, ms, count in rows:
        name = next((n for part, n in PROFILED if part in key), None)
        if name is not None:
            ms0, c0 = prof.get(name, (0.0, 0))
            prof[name] = ms0 + ms, c0 + count
    for e in events:
        if e.track == "kernel":
            name = "rope_elite" if e.name == "rope_elite_qk" else e.name
            ms0, c0 = spans.get(name, (0.0, 0))
            spans[name] = ms0 + e.dur * 1e3, c0 + 1
    if set(spans) != set(prof):
        raise AssertionError(f"profiler kernels {sorted(prof)} != span names {sorted(spans)}")
    return {name: spans[name] + prof[name] for name in sorted(spans)}


def observability(params, buffers, cfg, dev, card: str, runs: dict) -> None:
    """Phase 3h: each of ``runs`` ({label: (SchedulerConfig, requests,
    untraced streams, untraced report)}) again, traced; the kernel spans
    against the profiler; tracing's cost in turns."""
    import bisect
    import collections
    import re
    import numpy as np
    from repro_torch.kernels import build, ops
    from repro_torch.launch import diagnose
    from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer, write_chrome_trace
    from repro_torch.runtime import serve_loop
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for label, (scfg, reqs, want, urep) in runs.items():
        tr, metrics = Tracer(), MetricsRegistry()
        rep, launches, _, sched = serve_run(f"traced {label}", params, buffers, cfg, scfg,
                                            reqs, card, tracer=tr, metrics=metrics)
        got = {r.uid: r.generated for r in sched.finished}
        if got != want:
            bad = sorted(u for u in want if got.get(u) != want[u])
            raise AssertionError(f"traced {label}: streams {bad} differ from the untraced "
                                 f"run's")
        t0 = time.perf_counter()
        events = tr.events()
        spans = collections.Counter(e.name for e in events if e.track == "kernel")
        spans["rope_elite"] += spans.pop("rope_elite_qk", 0)    # both entries count there
        spans = {k: v for k, v in spans.items() if v}
        counted = {k: v for k, v in launches.items() if v}
        if spans != counted:
            raise AssertionError(f"traced {label}: kernel spans {spans} != launches {counted}")
        stem = re.sub(r"\W+", "_", label)
        paths[label] = write_chrome_trace(out_dir / f"{stem}.json", tr)
        prom = out_dir / f"{stem}.prom"
        prom.write_text(metrics.to_prometheus())
        t_export = time.perf_counter() - t0
        chk = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"),
                              str(paths[label]), "--metrics", str(prom)],
                             capture_output=True, text=True, timeout=300)
        if chk.returncode:
            raise AssertionError(f"traced {label}: check_trace failed\n{chk.stdout[-3000:]}")
        host = [e for e in events if e.track != "kernel"]
        steps = max(rep.decode_steps, 1)
        print(f"[{card}] traced {label}: tokens == untraced run's on all {len(got)} streams; "
              f"{rep.trace_events} events, {rep.trace_dropped} dropped by the ring: "
              f"{sum(spans.values())} kernel spans == launches, {len(host)} host events; "
              f"{rep.trace_events / steps:.1f} per decode step ({len(host) / steps:.1f} "
              f"host); step_ms p50 {rep.step_ms_p50:.2f} vs {urep.step_ms_p50:.2f} in the "
              f"untraced run; export {t_export * 1e3:.0f} ms, "
              f"{paths[label].stat().st_size} B; {chk.stdout.strip().splitlines()[-1]}",
              flush=True)
        swaps = [e for e in events if e.name in ("swap_out", "swap_in")]
        if swaps:
            if not all(e.arg("device_ms") > 0 for e in swaps):
                raise AssertionError(f"traced {label}: a swap span without device time")
            for name in ("swap_out", "swap_in"):
                sw = [e for e in swaps if e.name == name]
                print(f"[{card}] traced {label}: {len(sw)} {name} spans, host "
                      f"{sum(e.dur for e in sw) * 1e3:.2f} ms, device (gather/scatter "
                      f"and copy) {sum(e.arg('device_ms') for e in sw):.2f} ms", flush=True)
    # the f32 run's step from its spans: host phases per decode step, and
    # the card's time in the kernel spans inside each decode phase
    label = next(iter(runs))
    records = json.loads(paths[label].read_text())["traceEvents"]
    phase = {}
    for e in records:
        if e["ph"] == "X" and e.get("cat") == "phase":
            phase.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in records
                  if e["ph"] == "X" and e.get("cat") == "kernel")
    starts = [k[0] for k in kern]
    inside, dec_ms = [], {}
    for a, b in phase.get("decode", []):
        k = [x for x in kern[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]
             if x[1] <= b]
        inside.append(len(k))
        for s, t, n in k:
            dec_ms[n] = dec_ms.get(n, 0.0) + (t - s) / 1e3
    n_dec = max(len(phase.get("decode", [])), 1)
    print(f"[{card}] traced {label} from its spans: host phases, mean per call "
          + ", ".join(f"{p} {sum(b - a for a, b in v) / 1e3 / len(v):.3f} ms x{len(v)}"
                      for p, v in sorted(phase.items()))
          + f"; kernel spans inside a decode phase min/p50/max {min(inside)}/"
          f"{int(np.median(inside))}/{max(inside)}, their card time per decode step "
          + ", ".join(f"{n} {v / n_dec:.4f} ms" for n, v in dec_ms.items()), flush=True)
    diagnose.main(["trace-summary", str(paths[label]), "--top", "4"])
    # the spans against the profiler's device time, kernel by kernel; then
    # the same window with the launch gate's stream wait taken out, which
    # shows what the gate keeps out of a span (the host's time to issue)
    for gated in (True, False):
        tr = Tracer()
        title = f"f32 dense, kernel tracer armed, {'gated' if gated else 'gate taken out'}"
        if gated:
            rows = profile_decode(params, buffers, cfg, dev, card, title, tracer=tr)
        else:
            wait, build._GATE["wait"] = build._GATE["wait"], lambda *a: 0
            try:
                rows = profile_decode(params, buffers, cfg, dev, card, title, tracer=tr)
            finally:
                build._GATE["wait"] = wait
        for name, (s_ms, s_n, p_ms, p_n) in spans_vs_profiler(rows, tr.events()).items():
            excess_us = (s_ms - p_ms) / s_n * 1e3
            print(f"[{card}] spans vs profiler, {'gated' if gated else 'ungated'}, {name}: "
                  f"{s_n} spans / {p_n} profiled launches, span sum {s_ms:.3f} ms, profiler "
                  f"device {p_ms:.3f} ms ({100 * (s_ms / p_ms - 1):+.1f}%), per launch "
                  f"{s_ms / s_n * 1e3:.2f} vs {p_ms / p_n * 1e3:.2f} us "
                  f"(+{excess_us:.2f} us)", flush=True)
            if s_n != p_n or (gated and (s_ms < 0.95 * p_ms or excess_us > 10.0)):
                raise AssertionError(f"{name}: spans do not measure the card's launches")
    # tracing's cost: one scheduler at 8 steady lanes, turns U T T U of 10
    # decode steps, untraced and traced (scheduler, pool and kernel tracer)
    scfg = serve_loop.SchedulerConfig(max_slots=8, block_size=16, num_blocks=512,
                                      max_new_tokens=256, max_len=1024,
                                      prefill_chunk_tokens=256, prefill_batch_lanes=8)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=dev)
    rng = np.random.default_rng(2)
    for i in range(8):
        sched.submit(serve_loop.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=256))
    for _ in range(3):
        sched.step()
    tr, times, turns = Tracer(), {"U": [], "T": []}, []
    try:
        for _ in range(5):
            for mode in "UTTU":
                on = tr if mode == "T" else None
                sched.trace = sched.pool.trace = on or NULL_TRACER
                ops.set_kernel_tracer(on, device=dev)
                turn = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    sched.step()
                    turn.append((time.perf_counter() - t0) * 1e3)
                times[mode] += turn
                turns.append(f"{mode}{np.median(turn):.2f}")
    finally:
        ops.set_kernel_tracer(None)
    u50, t50 = np.percentile(times["U"], 50), np.percentile(times["T"], 50)
    print(f"[{card}] tracing cost in turns (5 x U T T U of 10 steady f32 decode steps of 8 "
          f"lanes, one scheduler): decode step p50 untraced {u50:.3f} ms, traced "
          f"{t50:.3f} ms ({100 * (t50 / u50 - 1):+.1f}%); {tr.emitted / len(times['T']):.1f} "
          f"events per traced step, {tr.dropped} dropped; turn medians {' '.join(turns)}",
          flush=True)


def near_tie_margin(params, buffers, cfg, tokens, dev) -> float:
    """Top-1/top-2 logits margin of the full model's next token after
    ``tokens``, from a one-shot prefill into a fresh pool."""
    import numpy as np
    import torch
    from repro_torch.core.cache import PagedKVPool
    from repro_torch.models import lm
    n = len(tokens)
    pool = PagedKVPool(cfg, -(-n // 16), 16, device=dev)
    pool.ensure_capacity(0, n)
    sm = pool.prefill_slot_mapping(0, 0, n, n)[None]
    logits = lm.apply_prefill_paged(
        params, buffers, cfg, torch.from_numpy(np.asarray(tokens, np.int32)[None]).to(dev),
        pool.pages, torch.from_numpy(sm))
    top = torch.topk(logits[0, n - 1].double(), 2).values
    return float(top[0] - top[1])


def compare_streams(label, streams, params, buffers, cfg, dev, card,
                    against: str = "plain run's") -> int:
    """Greedy streams against a reference run's on the same requests;
    ``streams`` is [(uid, prompt, tokens, reference tokens)].  A stream may
    part from the reference only where the reference's token is a near-tie
    (``near_tie_margin`` of prompt + reference stream up to that token
    under NEAR_TIE); it is then compared no further.  Any other difference
    raises.  → the number of such near-tie tokens."""
    import numpy as np
    ties = 0
    for uid, prompt, got, want in streams:
        got, want = list(got), list(want)
        diff = [t for t, (a, b) in enumerate(zip(got, want)) if a != b]
        if not diff and len(got) == len(want):
            continue
        if not diff:
            raise AssertionError(f"{label} request {uid}: stream length differs")
        t = diff[0]
        ctx = np.concatenate([prompt, np.asarray(want[:t], np.int32)])
        margin = near_tie_margin(params, buffers, cfg, ctx, dev)
        print(f"[{card}] {label} request {uid}: token {t} is {got[t]} against "
              f"{want[t]}; reference margin {margin:.3e}", flush=True)
        if not margin < NEAR_TIE:
            raise AssertionError(f"{label} request {uid}: stream differs at token {t} "
                                 f"with margin {margin} >= {NEAR_TIE}")
        ties += 1
    print(f"[{card}] {label}: streams == {against} ({ties} near-tie tokens)", flush=True)
    return ties


def record_draws(draws: dict):
    """Patch ``serve_loop.sample_tokens`` so that every sampled lane's draw
    leaves its logits row (a device copy) and token in ``draws`` under
    (seed, token index), and ``serve_loop._spec_uniform`` so that each
    residual draw of a rejected draft leaves ("residual", seed, token
    index); → a function that undoes the patches."""
    import torch
    from repro_torch.runtime import serve_loop
    real, real_u = serve_loop.sample_tokens, serve_loop._spec_uniform

    def rec(logits, temps, top_ps, seeds, counts):
        out = real(logits, temps, top_ps, seeds, counts)
        lanes = torch.nonzero(temps > 0)[:, 0]
        keys = torch.stack([seeds[lanes].long(), counts[lanes].long(), out[lanes]], 1)
        for row, (seed, count, tok) in zip(logits[lanes].float(), keys.tolist()):
            draws[seed, count] = row, tok
        return out

    def rec_u(seed, count, salt):
        if salt == serve_loop._RESID_SALT:
            draws["residual", seed, count] = True
        return real_u(seed, count, salt)

    serve_loop.sample_tokens, serve_loop._spec_uniform = rec, rec_u

    def undo():
        serve_loop.sample_tokens, serve_loop._spec_uniform = real, real_u
    return undo


def flip_distances(draws: dict, req_of: dict, keys) -> "np.ndarray":
    """``sampling_margins.flip_distance`` of the recorded draws ``keys``
    ((seed, count) pairs; ``req_of`` maps a seed to its request), 256 rows
    at a time."""
    import numpy as np
    import torch
    from sampling_margins import flip_distance
    out = []
    for i in range(0, len(keys), 256):
        part = keys[i:i + 256]
        rows = torch.stack([draws[k][0] for k in part])
        reqs = [req_of[seed] for seed, _ in part]
        t = lambda v, dt: torch.tensor(v, dtype=dt, device=rows.device)
        out.append(flip_distance(rows, t([r.temperature for r in reqs], torch.float32),
                                 t([r.top_p for r in reqs], torch.float32),
                                 t([r.seed for r in reqs], torch.int32),
                                 t([c for _, c in part], torch.int32)))
    return np.concatenate(out) if out else np.zeros(0)


def compare_sampled(label, streams, want_draws: dict, got_draws: dict, reqs: dict,
                    card: str, against: str) -> dict:
    """Sampled streams against a reference run's, through the logits rows
    each token was drawn from (``record_draws``); ``streams`` is [(uid,
    prompt, tokens, reference tokens)], ``reqs`` {uid: Request}.

    Every token up to where a stream parts must come from a row within
    LOGIT_TOL (max abs) of the reference's row for the same request and
    token index.  Where a stream parts, its row and the reference's must
    also differ by at least the reference draw's flip distance (the least
    move of the logits that may change the draw, less FLIP_SLACK): the
    change of token is then one the rows' difference can make.  A token
    that is not its own run's draw (a rejected draft, replaced by the
    residual draw, which ``record_draws`` saw) may part a stream; it is
    counted and printed.  Anything else fails, after every stream is
    checked and printed.
    → {"parted", "rejected", "draws", "bitwise", "max_d"}."""
    import numpy as np
    import torch
    st = dict(parted=0, rejected=0, draws=0, bitwise=0, max_d=0.0)
    bad = []
    for uid, prompt, got, want in streams:
        got, want, seed = list(got), list(want), reqs[uid].seed
        diff = [t for t, (a, b) in enumerate(zip(got, want)) if a != b]
        if not diff and len(got) != len(want):
            bad.append(f"request {uid}: stream length differs")
            continue
        n = diff[0] + 1 if diff else len(want)
        missing = [c for c in range(n) if (seed, c) not in want_draws
                   or (seed, c) not in got_draws]
        if missing:
            bad.append(f"request {uid}: no recorded draw at tokens {missing[:4]}")
            continue
        A = torch.stack([want_draws[seed, c][0] for c in range(n)])
        B = torch.stack([got_draws[seed, c][0] for c in range(n)])
        d = (A.double() - B.double()).abs().amax(-1).cpu().numpy()
        st["draws"] += n
        st["bitwise"] += int((d == 0).sum())
        st["max_d"] = max(st["max_d"], float(d.max()))
        if [want_draws[seed, c][1] for c in range(n)] != want[:n]:
            bad.append(f"request {uid}: the reference stream is not its draws")
        wrong = [c for c in range(min(n, len(got))) if got_draws[seed, c][1] != got[c]
                 and ("residual", seed, c) not in got_draws]
        if wrong and wrong[0] < n - 1:
            bad.append(f"request {uid}: token {wrong[0]} is not the run's draw")
            continue
        far = np.flatnonzero(d > LOGIT_TOL)
        if len(far):
            bad.append(f"request {uid}: rows differ by {d[far[0]]:.3e} > {LOGIT_TOL} at "
                       f"token {far[0]} ({len(far)} of {n} tokens)")
            continue
        if not diff:
            continue
        t = diff[0]
        if got_draws[seed, t][1] != got[t]:
            if ("residual", seed, t) not in got_draws:
                bad.append(f"request {uid}: token {t} is {got[t]}, neither the run's draw "
                           f"{got_draws[seed, t][1]} nor a residual draw")
                continue
            st["rejected"] += 1
            print(f"[{card}] {label} request {uid}: token {t} is a residual draw "
                  f"{got[t]} (draft {got_draws[seed, t][1]}) against {want[t]}; rows "
                  f"differ by {d[t]:.3e}", flush=True)
            continue
        flip = float(flip_distances(want_draws, {seed: reqs[uid]}, [(seed, t)])[0])
        slack = FLIP_SLACK * float(A[t].abs().max())
        st["parted"] += 1
        print(f"[{card}] {label} request {uid}: token {t} is {got[t]} against {want[t]}; "
              f"rows differ by {d[t]:.3e} (<= {LOGIT_TOL}), the draw's flip distance "
              f"{flip:.3e}", flush=True)
        if not d[t] + slack >= flip:
            bad.append(f"request {uid}: token {t} parted with rows {d[t]:.3e} apart, under "
                       f"the draw's flip distance {flip:.3e}")
    print(f"[{card}] {label}: {st['draws']} draws compared with the {against}: rows "
          f"bitwise equal {st['bitwise']}, max |logits difference| {st['max_d']:.3e} "
          f"(limit {LOGIT_TOL}); {st['parted']} streams parted where the rows' "
          f"difference can move the draw, {st['rejected']} at a residual draw", flush=True)
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return st


def sched_streams(plain_sched, spec_sched):
    """compare_streams' pairs from two schedulers' finished requests."""
    plain = {r.uid: r.generated for r in plain_sched.finished}
    return [(r.uid, r.prompt, r.generated, plain[r.uid]) for r in spec_sched.finished]


def generate_run(label, params, buffers, cfg, prompts, new_tokens: int, want, card):
    """Lockstep ``generate`` with the counts set to 0 just before and read
    just after; the launches must be exactly ``want``.  Prints tok/s, step
    ms and the measured cache, which must equal the per-token formula.
    The recorder keeps each kernel's dispatch calls, ``rope_elite``'s as
    ``rope_elite_qk``.  → (tokens, stats, wall_s, recorder, launches)."""
    import numpy as np
    import torch
    from repro_torch.core.cache import model_cache_floats_per_token, ssm_state_floats
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    rec = Recorder(cfg.n_attn_layers, names=tuple(ENTRY.get(k, k) for k in want))
    dev = lm.params_device(params)
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        out, stats = serve_loop.generate(params, buffers, cfg, prompts, new_tokens,
                                         device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches()
    finally:
        rec.close()
    B, Sp = prompts.shape
    dec = np.asarray(stats.step_ms[1:])
    print(f"[{card}] {label}: {B} x ({Sp} prompt + {new_tokens} new) in {wall:.3f} s: "
          f"decode tok/s={stats.decoded_tokens / wall:.1f}, prefill step "
          f"{stats.step_ms[0]:.2f} ms, decode step_ms p50/p95="
          f"{np.percentile(dec, 50):.2f}/{np.percentile(dec, 95):.2f}, measured cache "
          f"{stats.cache_bytes / 2**20:.2f} MiB ({stats.cache_bytes} B)"
          + (f", Mamba state {stats.ssm_bytes / 2**20:.2f} MiB ({stats.ssm_bytes} B)"
             if stats.ssm_bytes else ""), flush=True)
    got = {k: v for k, v in launches.items() if v}
    print(f"{label} launches: {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    if out.shape != (B, new_tokens) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: bad output {out.shape} {out[:, :8]}")
    cache_want = 4 * model_cache_floats_per_token(cfg) * B * (Sp + new_tokens)
    if stats.cache_bytes != cache_want:
        raise AssertionError(f"{label}: cache {stats.cache_bytes} B, expected {cache_want}")
    if stats.ssm_bytes != 4 * ssm_state_floats(cfg, B):
        raise AssertionError(f"{label}: Mamba state {stats.ssm_bytes} B, expected "
                             f"{4 * ssm_state_floats(cfg, B)}")
    return out, stats, wall, rec, got


def pool_contents(pool, seq_id: int, length: int):
    """{leaf: a copy of ``seq_id``'s first ``length`` slots in token order,
    or its chain's block-summary rows}."""
    import numpy as np
    import torch
    bs = pool.block_size
    slots = torch.as_tensor(pool.flat_slots(seq_id, np.arange(length)), device=pool.device)
    chain = torch.tensor(pool.block_table(seq_id)[:-(-length // bs)], device=pool.device)
    return {n: (a[:, chain] if n.endswith(("_blkmean", "_blkmax")) else a[:, slots]).clone()
            for n, a in pool.pages["p0"].items()}


def watch_swaps(sched, checked: list) -> None:
    """Wrap ``sched``'s swap-out and swap-in so the first sequence swapped
    out is copied before, and compared bit for bit after it is restored
    (every leaf: codes, scales, summary rows); ``checked`` gets
    (uid, length, leaves) once it matched."""
    import torch
    bm, pool, kept = sched.bm, sched.pool, {}
    swap_out, swap_in = bm.preempt_swap_out, bm.swap_in

    def out(seq_id, length):
        if not kept and length > 0:
            kept[seq_id] = length, pool_contents(pool, seq_id, length)
        return swap_out(seq_id, length)

    def back(seq_id, swapped):
        swap_in(seq_id, swapped)
        if seq_id in kept and not checked:
            length, before = kept[seq_id]
            after = pool_contents(pool, seq_id, length)
            bad = [n for n in before if not torch.equal(before[n], after[n])]
            if bad:
                raise AssertionError(f"swap round trip of sequence {seq_id} changed {bad}")
            checked.append((seq_id, length, sorted(before)))

    bm.preempt_swap_out, bm.swap_in = out, back


def serving_features(params, buffers, cfg, dev, card: str, base: dict) -> dict:
    """Phase 3g: sampled serving, the prefix cache and host swap at full
    width, each run through ``serve_run`` (22 launches per forward, nothing
    else).  → the numbers phase 4 prints."""
    import numpy as np
    import torch
    from repro_torch.core.cache import BlockManager, PagedKVPool
    from repro_torch.launch.serve import make_stream
    from repro_torch.runtime import serve_loop
    SC = serve_loop.SchedulerConfig
    out = {}
    # sampled f32 runs, 12 requests: undisturbed, its greedy twin (the
    # sampler's cost), and on a pool of 160 blocks with each eviction
    stream = lambda temp: make_stream(cfg, 12, rate=0.5, prompt_len=512, new_tokens=128,
                                      seed=10, prompt_min=64, new_min=64, temperature=temp,
                                      top_p=0.95, sample_seed=100)
    sampled = {r.uid: r for r in stream(0.8)}
    ref_draws = {}
    rep, _, _, plain = serve_run("sampled f32 12 requests", params, buffers, cfg, SC(**base),
                                 stream(0.8), card, draws=ref_draws)
    grep_, _, _, gplain = serve_run("greedy twin f32 12 requests", params, buffers, cfg,
                                    SC(**base), stream(0.0), card)
    out["sampled"], out["greedy"] = rep, grep_
    # how far each undisturbed draw is from changing: the old near-tie
    # limit (2 x flip distance under NEAR_TIE) against LOGIT_TOL
    flip = flip_distances(ref_draws, {r.seed: r for r in sampled.values()}, sorted(ref_draws))
    q = np.percentile(2 * flip, [0, 5, 50, 95, 100])
    print(f"[{card}] sampled f32 12 requests: {len(flip)} draws, 2 x flip distance "
          f"min/p5/p50/p95/max {'/'.join(f'{v:.3e}' for v in q)}; under NEAR_TIE "
          f"{NEAR_TIE}: {np.mean(2 * flip < NEAR_TIE):.2%}, flip distance under "
          f"LOGIT_TOL {LOGIT_TOL}: {np.mean(flip < LOGIT_TOL):.2%}", flush=True)
    for eviction in ("recompute", "swap"):
        label, draws = f"sampled tight pool {eviction}", {}
        trep, _, _, tsched = serve_run(f"{label} 12 requests", params, buffers, cfg,
                                       SC(**dict(base, num_blocks=160, eviction=eviction)),
                                       stream(0.8), card, draws=draws)
        if not trep.preemptions > 0 or (eviction == "swap") != (trep.swap_outs > 0):
            raise AssertionError(f"{label}: preemptions {trep.preemptions}, "
                                 f"swaps {trep.swap_outs}/{trep.swap_ins}")
        out[f"cmp {eviction}"] = compare_sampled(
            label, sched_streams(plain, tsched), ref_draws, draws, sampled, card,
            "undisturbed sampled run's")
        out[f"tight {eviction}"] = trep
        out[f"streams {eviction}"] = {r.uid: r.generated for r in tsched.finished}
    # the swap run's greedy twin, where the top-2 margin decides
    gtrep, _, _, gtsched = serve_run("greedy tight pool swap 12 requests", params, buffers,
                                     cfg, SC(**dict(base, num_blocks=160, eviction="swap")),
                                     stream(0.0), card)
    if not gtrep.swap_outs > 0:
        raise AssertionError(f"greedy tight pool swap: swaps {gtrep.swap_outs}")
    compare_streams(
        "greedy tight pool swap", sched_streams(gplain, gtsched), params, buffers, cfg, dev,
        card, against="greedy twin's")
    # sampled speculation, k=4 with the full-rank draft
    draws = {}
    srep, _, _, ssched = serve_run("sampled spec k=4 r=full 12 requests", params, buffers,
                                   cfg, SC(**base, speculate_k=4), stream(0.8), card,
                                   draws=draws)
    out["cmp spec"] = compare_sampled("sampled spec k=4 r=full", sched_streams(plain, ssched),
                                      ref_draws, draws, sampled, card,
                                      "plain sampled run's")
    if not srep.acceptance_rate >= 0.99:
        raise AssertionError(f"sampled spec full-rank: acceptance {srep.acceptance_rate}")
    out["spec"] = srep
    del ref_draws, draws
    # the prefix cache, off then on: 16 requests behind one 256-token
    # prefix, sampled (the logits rows decide) and greedy (the top-2 margin)
    for temp in (0.8, 0.0):
        kind = "sampled" if temp > 0 else "greedy"
        pstream = lambda: make_stream(cfg, 16, rate=0.5, prompt_len=256, new_tokens=128,
                                      seed=11, prompt_min=64, new_min=64, shared_prefix=256,
                                      temperature=temp, top_p=0.95, sample_seed=200)
        d_off, d_on = ({}, {}) if temp > 0 else (None, None)
        off, _, _, off_sched = serve_run(f"prefix cache off {kind} 16 requests", params,
                                         buffers, cfg, SC(**base), pstream(), card,
                                         draws=d_off)
        on, _, _, on_sched = serve_run(f"prefix cache on {kind} 16 requests", params,
                                       buffers, cfg, SC(**base, prefix_cache=True), pstream(),
                                       card, draws=d_on)
        pairs = sched_streams(off_sched, on_sched)
        if temp > 0:
            compare_sampled(f"prefix cache on {kind}", pairs, d_off, d_on,
                            {r.uid: r for r in pstream()}, card, "cache-off run's")
            out["prefix off"], out["prefix on"] = off, on
            out["streams prefix on"] = {r.uid: r.generated for r in on_sched.finished}
        else:
            compare_streams(f"prefix cache on {kind}", pairs, params, buffers, cfg, dev,
                            card, against="cache-off run's")
        if not (on.prefix_cache_hit_tokens > 0 and on.prefill_forward_tokens
                == off.prefill_forward_tokens - on.prefix_cache_hit_tokens):
            raise AssertionError(f"prefix cache {kind}: {on.prefill_forward_tokens} tokens "
                                 f"prefilled, cache off {off.prefill_forward_tokens}, hits "
                                 f"{on.prefix_cache_hit_tokens}")
        del d_off, d_on
    # int8 + partial sparse (k=4+2), preempt admission, swap eviction, tight
    checked = []
    qrep, *_ = serve_run(
        "int8 + sparse k=4+2 swap tight pool 10 requests", params, buffers, cfg,
        SC(**dict(base, num_blocks=200, cache_dtype="int8", sparse_topk_blocks=4,
                  sparse_recent_blocks=2, eviction="swap")),
        make_stream(cfg, 10, rate=0.5, prompt_len=768, new_tokens=128, seed=12,
                    prompt_min=512, new_min=64), card,
        setup=lambda sched: watch_swaps(sched, checked))
    if not (qrep.preemptions > 0 and qrep.swap_outs > 0 and checked):
        raise AssertionError(f"int8 sparse swap: preemptions {qrep.preemptions}, swaps "
                             f"{qrep.swap_outs}, round trips checked {len(checked)}")
    if not qrep.mean_selected_blocks < qrep.mean_candidate_blocks:
        raise AssertionError("int8 sparse swap: the selection was never partial")
    uid, length, leaves = checked[0]
    print(f"[{card}] int8 sparse swap: sequence {uid} ({length} tokens) restored bit for "
          f"bit after swap-out/in, leaves {leaves}", flush=True)
    out["int8 swap"] = qrep
    # swap-out and swap-in of one 1024-token sequence, f32 and int8 pools
    for dtype in ("float32", "int8"):
        pool = PagedKVPool(cfg, base["num_blocks"], 16, device=dev, dtype=dtype,
                           block_summaries=dtype == "int8")
        bm = BlockManager(pool)
        times = []
        for _ in range(7):
            bm.grow(0, 1024)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            swapped = bm.preempt_swap_out(0, 1024)
            swapped.ready.synchronize()
            t1 = time.perf_counter()
            bm.swap_in(0, swapped)
            torch.cuda.synchronize()
            times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            bm.release(0)
        t_out, t_in = np.median(np.asarray(times[2:]), axis=0)
        out[f"swap {dtype}"] = swapped.nbytes(), t_out, t_in
    # the sampler alone at the decode step's shape, against the argmax
    logits = torch.randn(base["max_slots"], cfg.vocab_size, device=dev) * 3
    args = (logits, torch.full((base["max_slots"],), 0.8, device=dev),
            torch.full((base["max_slots"],), 0.95, device=dev),
            torch.arange(base["max_slots"], dtype=torch.int32, device=dev),
            torch.full((base["max_slots"],), 7, dtype=torch.int32, device=dev))
    out["sampler ms"] = time_ms(lambda: serve_loop.sample_tokens(*args), ahead=False)
    out["argmax ms"] = time_ms(lambda: logits.argmax(-1), ahead=False)
    return out


# -- the data-parallel replica router (phase 3p) ---------------------------------

DP_REQUESTS, DP_NEW, DP_PROMPT = 8, 32, (64, 256)
DP_SHARED = 64               # the prefix scenario's shared prompt prefix
DP_TIGHT_BLOCKS = 32         # plain and recompute: every replica and the single preempt
DP_BASE = dict(max_slots=4, block_size=16, num_blocks=96, max_new_tokens=DP_NEW,
               max_len=DP_SHARED + DP_PROMPT[1] + DP_NEW, prefill_chunk_tokens=128,
               prefill_batch_lanes=4)


def router_run(label, params, buffers, cfg, scfg, reqs, dev, card: str, draws=None,
               rows=None, tracer=None, metrics=None, meshes=None):
    """``reqs`` through a ``Router`` of two replicas on ``dev`` (or one per
    ``TPMesh`` of ``meshes``), with the
    counts set to 0 just before and read just after: outputs checked, and
    each replica's launches must be ``path_kernels`` of its own report
    (the replicas' together the whole run's).  ``draws``/``rows`` record
    sampled draws and greedy logits rows (one dict per replica).
    → (report, router)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime.router import Router
    L = cfg.n_attn_layers
    placed = dict(devices=[dev, dev]) if meshes is None else dict(meshes=meshes)
    router = Router(params, buffers, cfg, scfg, num_replicas=2, tracer=tracer,
                    metrics=metrics, **placed)
    undo = [record_draws(draws)] if draws is not None else []
    if rows is not None:
        undo.append(record_greedy_rows(router.replicas, rows))
    ops.reset_launches()
    ops.set_kernel_tracer(tracer, device=router.shard_devices())
    try:
        rep = router.run(reqs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if v}
    finally:
        ops.set_kernel_tracer(None)
        for u in undo:
            u()
    print(f"[{card}] {label}: {rep.summary()}", flush=True)
    print(rep.per_replica_table())
    if rep.completed != len(reqs) or sorted(router.finished_tokens()) != \
            sorted(r.uid for r in reqs):
        raise AssertionError(f"{label}: {rep.completed}/{len(reqs)} requests finished")
    for r in (q for s in router.replicas for q in s.finished):
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label} request {r.uid}: bad output {toks[:8]}...")
    for i, (r, got, s) in enumerate(zip(rep.replicas, rep.launches, router.replicas)):
        want = path_kernels(scfg, r, L, 1 if s.mesh is None else s.mesh.tp)
        if got != want or not all(want.values()):
            raise AssertionError(f"{label} replica {i}: launches {got}, expected {want} "
                                 f"(its forwards x layers)")
    merged = {k: sum(n.get(k, 0) for n in rep.launches) for k in launches}
    if merged != launches:
        raise AssertionError(f"{label}: replicas' launches {rep.launches} != the run's "
                             f"{launches}")
    return rep, router


def rows_agree(label: str, want_rows: dict, got_rows: list, streams, card: str) -> dict:
    """The logits rows of one scheduler's run against a router run's, for
    each token up to and including where a stream parts: bitwise-equal
    count and max |difference|, which must be within LOGIT_TOL (the same
    context through another batch).  → counts."""
    import torch
    got = {k: v for r in got_rows for k, v in r.items()}
    st = dict(rows=0, bitwise=0, max_d=0.0)
    for uid, _, toks, ref in streams:
        diff = [t for t, (a, b) in enumerate(zip(toks, ref)) if a != b]
        n = diff[0] + 1 if diff else len(ref)
        both = [t for t in range(n) if (uid, t) in want_rows and (uid, t) in got]
        if not both:
            continue
        A = torch.stack([want_rows[uid, t] for t in both]).double()
        B = torch.stack([got[uid, t] for t in both]).double()
        d = (A - B).abs().amax(-1)
        st["rows"] += len(both)
        st["bitwise"] += int((d == 0).sum())
        st["max_d"] = max(st["max_d"], float(d.max()))
    print(f"[{card}] {label}: {st['rows']} logits rows against one Scheduler's: bitwise "
          f"equal {st['bitwise']} ({100 * st['bitwise'] / max(st['rows'], 1):.1f}%), max "
          f"|difference| {st['max_d']:.3e} (limit {LOGIT_TOL})", flush=True)
    if not st["max_d"] <= LOGIT_TOL:
        raise AssertionError(f"{label}: logits rows differ by {st['max_d']:.3e}")
    return st


def data_parallel(params, buffers, cfg, dev, card: str) -> dict:
    """Phase 3p: every scenario through one ``Scheduler`` and through two
    router replicas sharing the card; a traced routed run.  → figures."""
    import collections
    import numpy as np
    import torch
    from repro_torch.obs import MetricsRegistry, Tracer, write_chrome_trace
    from repro_torch.runtime import serve_loop, sharded_check
    from repro_torch.launch import diagnose
    t_phase = time.perf_counter()
    rng = np.random.default_rng(30)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
               for n in rng.integers(DP_PROMPT[0], DP_PROMPT[1] + 1, DP_REQUESTS)]
    out = {"scenarios": {}, "handoff": {}}
    untraced = None
    for name in list(sharded_check.SCENARIOS) + list(sharded_check.SAMPLED):
        t0 = time.perf_counter()
        knobs, req = sharded_check.scenario_knobs(name)
        if "shared" in req:
            req["shared"] = DP_SHARED
        kw = dict(DP_BASE, **knobs)
        if name in ("plain", "recompute"):
            kw["num_blocks"] = DP_TIGHT_BLOCKS
        scfg = serve_loop.SchedulerConfig(**kw)
        make = lambda req=req: sharded_check.build_requests(prompts, new_tokens=DP_NEW, **req)
        sampled = name in sharded_check.SAMPLED
        greedy_rows = not sampled and not scfg.speculate_k
        want_draws, got_draws = ({}, {}) if sampled else (None, None)
        want_rows, got_rows = {}, [{}, {}]
        setup = (lambda s: undo.append(record_greedy_rows([s], [want_rows]))) if greedy_rows \
            else None
        undo = []
        try:
            srep, _, _, sched = serve_run(f"3p {name} one Scheduler", params, buffers, cfg,
                                          scfg, make(), card, setup=setup, draws=want_draws)
        finally:
            for u in undo:
                u()
        rep, router = router_run(f"3p {name} dp=2", params, buffers, cfg, scfg, make(), dev,
                                 card, draws=got_draws, rows=got_rows if greedy_rows else None)
        got = router.finished_tokens()
        streams = [(r.uid, np.asarray(r.prompt, np.int32), got[r.uid], r.generated)
                   for r in sorted(sched.finished, key=lambda r: r.uid)]
        res = dict(routed=rep.routed, imbalance=rep.imbalance,
                   completed=[r.completed for r in rep.replicas],
                   occupancy=[r.mean_occupancy for r in rep.replicas],
                   tok_s=rep.tok_per_s, single_tok_s=srep.tok_per_s,
                   ttft=(rep.ttft_wall_p50_ms, rep.ttft_wall_p95_ms),
                   single_ttft=(srep.ttft_wall_p50_ms, srep.ttft_wall_p95_ms),
                   step_p50=[r.step_ms_p50 for r in rep.replicas],
                   single_step_p50=srep.step_ms_p50, launches=rep.launches,
                   preemptions=[r.preemptions for r in rep.replicas],
                   single_preemptions=srep.preemptions)
        if name in ("plain", "recompute") and not (srep.preemptions > 0
                                                   and rep.preemptions > 0):
            raise AssertionError(f"3p {name}: preemptions {srep.preemptions} (one "
                                 f"Scheduler), {res['preemptions']} (replicas): expected > 0")
        if sampled:
            reqs = {r.uid: r for r in sched.finished}
            res["sampled"] = compare_sampled(f"3p {name} dp=2", streams, want_draws,
                                             got_draws, reqs, card, "one Scheduler's draws")
            res["ties"] = 0
        else:
            res["ties"] = compare_streams(f"3p {name} dp=2", streams, params, buffers, cfg,
                                          dev, card, against="one Scheduler's")
        if greedy_rows:
            res["rows"] = rows_agree(f"3p {name} dp=2", want_rows, got_rows, streams, card)
        res["wall"] = time.perf_counter() - t0
        print(f"[{card}] 3p {name}: routed={res['routed']} imbalance={res['imbalance']:.2f} "
              f"completed={res['completed']} occupancy="
              f"{[round(o, 3) for o in res['occupancy']]} preemptions={res['preemptions']} "
              f"(one Scheduler {srep.preemptions}); tok/s {rep.tok_per_s:.1f} (one Scheduler "
              f"{srep.tok_per_s:.1f}), TTFT p50/p95 {rep.ttft_wall_p50_ms:.1f}/"
              f"{rep.ttft_wall_p95_ms:.1f} ms ({srep.ttft_wall_p50_ms:.1f}/"
              f"{srep.ttft_wall_p95_ms:.1f}); replica step p50 "
              f"{[round(x, 2) for x in res['step_p50']]} ms ({srep.step_ms_p50:.2f}); "
              f"near-tie tokens excused {res['ties']}; launches per replica {rep.launches}; "
              f"{res['wall']:.1f} s", flush=True)
        out["scenarios"][name] = res
        # what phase 3r holds its tp runs to, so that tp 1 is served once
        out["handoff"][name] = dict(
            scfg=scfg, make=make, tokens={r.uid: list(r.generated) for r in sched.finished},
            rows=want_rows if greedy_rows else None, draws=want_draws,
            counts=(srep.preemptions, srep.prefill_chunks, srep.decode_steps,
                    srep.draft_forwards),
            bpt_dev=sched.pool.bytes_per_token_per_device(),
            router=dict(tokens=got, rows=got_rows, routed=rep.routed,
                        counts=[(r.preemptions, r.prefill_chunks, r.decode_steps)
                                for r in rep.replicas])
            if name in TP_ROUTED else None)
        if name == "plain":
            untraced = (scfg, make, got)
    # the plain router run again, traced
    scfg, make, want = untraced
    tr, metrics = Tracer(), MetricsRegistry()
    rep, router = router_run("3p traced plain dp=2", params, buffers, cfg, scfg, make(), dev,
                             card, tracer=tr, metrics=metrics)
    if router.finished_tokens() != want:
        bad = sorted(u for u in want if router.finished_tokens().get(u) != want[u])
        raise AssertionError(f"3p traced plain dp=2: streams {bad} differ from the untraced "
                             f"router run's")
    events = tr.events()
    spans = collections.Counter(e.name for e in events if e.track == "kernel")
    spans["rope_elite"] += spans.pop("rope_elite_qk", 0)
    spans = {k: v for k, v in spans.items() if v}
    counted = {k: sum(n.get(k, 0) for n in rep.launches) for k in set().union(*rep.launches)}
    if spans != counted or not spans:
        raise AssertionError(f"3p traced plain: kernel spans {spans} != launches {counted}")
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = write_chrome_trace(out_dir / "router_plain.json", tr)
    prom = out_dir / "router_plain.prom"
    prom.write_text(metrics.to_prometheus())
    chk = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), str(path),
                          "--metrics", str(prom)], capture_output=True, text=True, timeout=300)
    if chk.returncode:
        raise AssertionError(f"3p traced plain: check_trace failed\n{chk.stdout[-3000:]}")
    routes = sum(e.name == "route" for e in events)
    print(f"[{card}] 3p traced plain dp=2: tokens == the untraced router run's on all "
          f"{len(want)} streams; {tr.emitted} events ({tr.dropped} dropped), {routes} route "
          f"instants, {sum(spans.values())} kernel spans == launches; "
          f"{chk.stdout.strip().splitlines()[-1]}", flush=True)
    diagnose.main(["trace-summary", str(path), "--top", "2"])
    out["traced_events"] = tr.emitted
    # the launcher in a fresh process (no kernel loaded yet), traced
    import os
    t0 = time.perf_counter()
    cli = out_dir / "router_cli"
    card_dev = str(torch.empty(0, device=dev).device)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--elitekv", "--stream", "--dp", "2",
         "--device", card_dev, "--requests", "6", "--prompt-len", "64", "--new-tokens", "8",
         "--prefill-chunk", "64", "--trace", f"{cli}.json", "--metrics-out", f"{cli}.prom"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    line = f"stream [tp=1 dp=2 devices={card_dev},{card_dev}]: dp=2 completed=6"
    if run.returncode or line not in run.stdout:
        raise AssertionError(f"3p launch/serve.py --dp 2 --trace: rc {run.returncode}\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    chk = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), f"{cli}.json",
                          "--metrics", f"{cli}.prom"], capture_output=True, text=True,
                         timeout=300)
    if chk.returncode:
        raise AssertionError(f"3p launcher trace: check_trace failed\n{chk.stdout[-3000:]}")
    print(f"[{card}] 3p launch/serve.py --stream --dp 2 --device {card_dev} --trace in a fresh "
          f"process: {run.stdout.splitlines()[0]}; {chk.stdout.strip().splitlines()[-1]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3p (data-parallel router) {out['wall']:.1f} s", flush=True)
    return out


# -- tensor-parallel paged attention (phase 3q) -----------------------------------
TP_PROMPTS = (64, 131, 200, 256)   # the four lanes' prompt tokens
TP_FIRST_CHUNK = 128               # the last lane's first chunk; its rest is resumed
TP_DECODE, TP_SPARSE, TP_W, TP_MB = 32, 8, 3, 24
TP_POOLS = (("f32", {}), ("int8", dict(dtype="int8")),
            ("f32 + summaries", dict(block_summaries=True)),
            ("int8 + summaries", dict(dtype="int8", block_summaries=True)))


def tp_forwards(params, buffers, cfg, mesh, pool_kw: dict):
    """One tp's forwards of phase 3q on a fresh pool over ``mesh``: a
    prefill of 4 lanes (the last lane's first chunk), that lane's second
    chunk resumed, then on a pool without summaries ``TP_DECODE`` dense
    decode steps and one verify window of ``TP_W``, on one with summaries
    ``TP_SPARSE`` sparse steps (k = 4 + 2).  Tokens are seeded, the same
    at every tp.  → (every forward's logits, the decode steps' device ms,
    the pool)."""
    import numpy as np
    import torch
    from repro_torch.core.cache import PagedKVPool
    from repro_torch.models import lm
    rng = np.random.default_rng(32)
    bs = 16
    pool = PagedKVPool(cfg, 4 * TP_MB, bs, mesh=mesh, **pool_kw)
    dev = mesh.devices[0]
    tok = lambda *s: torch.as_tensor(rng.integers(0, cfg.vocab_size, s), device=dev)
    lanes = list(range(len(TP_PROMPTS)))
    first = [min(n, TP_FIRST_CHUNK) if b == lanes[-1] else n for b, n in enumerate(TP_PROMPTS)]
    S = max(first)
    for b, n in zip(lanes, first):
        pool.ensure_capacity(b, n)
    sm = np.stack([pool.prefill_slot_mapping(b, 0, n, S) for b, n in zip(lanes, first)])
    out = [lm.apply_prefill_paged(params, buffers, cfg, tok(len(lanes), S), pool.pages,
                                  torch.from_numpy(sm), mesh=mesh)]
    b, start = lanes[-1], first[-1]
    n = TP_PROMPTS[-1] - start
    pool.ensure_capacity(b, start + n)
    cs = np.asarray([start], np.int32)
    out.append(lm.apply_prefill_paged(
        params, buffers, cfg, tok(1, n), pool.pages,
        torch.from_numpy(pool.prefill_slot_mapping(b, start, n, n)[None]), chunk_start=cs,
        block_tables=pool.block_table_array([b], TP_MB), prefix_lens=cs, block_size=bs,
        mesh=mesh))
    sparse = pool_kw.get("block_summaries", False)
    kw = dict(sparse_topk=4, sparse_recent=2) if sparse else {}
    step_ms = []
    for _ in range(TP_SPARSE if sparse else TP_DECODE):
        lengths = np.asarray([pool.length(s) + 1 for s in lanes], np.int32)
        for s in lanes:
            pool.ensure_capacity(s, int(lengths[s]))
        sm = pool.slot_mapping(lanes, (lengths - 1).tolist())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out.append(lm.apply_decode_paged(params, buffers, cfg, tok(len(lanes), 1), pool.pages,
                                         torch.from_numpy(sm),
                                         pool.block_table_array(lanes, TP_MB), lengths, bs,
                                         mesh=mesh, **kw))
        ev[1].record()
        step_ms.append(ev)
    if not sparse:
        offs = np.asarray([pool.length(s) for s in lanes], np.int32)
        for s in lanes:
            pool.ensure_capacity(s, int(offs[s]) + TP_W)
        sm = np.stack([pool.prefill_slot_mapping(s, int(offs[s]), TP_W, TP_W) for s in lanes])
        out.append(lm.apply_verify_paged(params, buffers, cfg, tok(len(lanes), TP_W),
                                         pool.pages, torch.from_numpy(sm),
                                         pool.block_table_array(lanes, TP_MB), offs,
                                         offs + TP_W, bs, mesh=mesh))
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in step_ms], pool


def tensor_parallel(params, buffers, cfg, dev, card: str) -> dict:
    """Phase 3q: the paged forwards of phase 3's TinyLlama-1.1B (22 layers,
    full width) at tp 1, 2 and 4 on a ``TPMesh`` of the one card, in four
    pools (f32, int8, each with and without block summaries): every logits
    row at tp 2 and 4 bitwise equal to tp 1, each run's launches those of
    its forwards (the attention kernels ``tp`` times per layer and
    forward), and ``elite_decode_paged`` at a shard's widths (PERF.md row
    1t) against its plain version, timed with its bound.  → figures."""
    import numpy as np
    import torch
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.elite_decode import decode_cost
    from repro_torch.launch.mesh import TPMesh
    t_phase = time.perf_counter()
    L = cfg.n_attn_layers
    out = {"runs": {}, "rows": []}
    shard_calls = {}
    with torch.no_grad():
        for kind, pool_kw in TP_POOLS:
            want = None
            for tp in (1, 2, 4):
                mesh = TPMesh.on(dev, tp)
                rec = (Recorder(L * tp, names=("elite_decode_paged",))
                       if kind == "f32" else None)
                ops.reset_launches()
                try:
                    logits, step_ms, pool = tp_forwards(params, buffers, cfg, mesh, pool_kw)
                    launches = {k: v for k, v in ops.launches().items() if v}
                finally:
                    if rec is not None:
                        rec.close()
                if rec is not None:
                    shard_calls[tp] = rec.calls["elite_decode_paged"][-1], launches[
                        "elite_decode_paged"]
                sparse = "summaries" in kind
                q8 = "_q8" if "int8" in kind else ""
                steps = TP_SPARSE if sparse else TP_DECODE
                expect = {"flash_prefill": 2 * L,
                          "rope_elite": (2 + steps + (0 if sparse else 1)) * L,
                          f"elite_decode_{'sparse_' if sparse else ''}paged{q8}": steps * L * tp}
                if not sparse:
                    expect["elite_verify_paged" + q8] = L * tp
                if launches != expect:
                    raise AssertionError(f"3q {kind} tp={tp}: launches {launches} != the "
                                         f"forwards' {expect}")
                for x in logits:
                    if not bool(torch.isfinite(x[..., :cfg.vocab_size]).all()):
                        raise AssertionError(f"3q {kind} tp={tp}: logits not finite")
                if want is None:
                    want = logits
                else:
                    bad = [i for i, (g, w) in enumerate(zip(logits, want))
                           if not torch.equal(g, w)]
                    if len(logits) != len(want) or bad:
                        d = max(float((logits[i] - want[i]).abs().max()) for i in bad)
                        raise AssertionError(f"3q {kind} tp={tp}: forwards {bad} differ from "
                                             f"tp 1's (max |d| {d:.3e})")
                rows = sum(x.shape[0] * x.shape[1] for x in logits)
                res = dict(bpt=pool.bytes_per_token(),
                           bpt_dev=pool.bytes_per_token_per_device(),
                           step_p50=float(np.median(step_ms)), launches=launches, rows=rows)
                out["runs"][(kind, tp)] = res
                print(f"[{card}] 3q {kind} tp={tp}: {len(logits)} forwards, {rows} logits rows"
                      f"{' bitwise equal to tp 1' if tp > 1 else ''}; pool bytes per token "
                      f"{res['bpt']} global, {res['bpt_dev']} per device; "
                      f"{'sparse' if sparse else 'dense'} decode step p50 "
                      f"{res['step_p50']:.3f} ms (CUDA events, {len(step_ms)} steps); "
                      f"launches {launches}", flush=True)
                del logits, pool
            del want
    # PERF.md row 1t: elite_decode_paged at a shard's widths, beside row 1 at
    # the same step (tp 1), each as the main path launched it
    scratch = torch.empty(64 * 2**20 // 4, device=dev)
    nkv = cfg.n_kv_heads
    for tp, (a, n) in sorted(shard_calls.items()):
        got = ed.elite_decode_paged(*a, split_nkv=nkv)
        err = check(f"3q elite_decode_paged tp={tp} shard (nkv {a[2].shape[1]})",
                    max_err(got, ref.elite_decode_paged_ref(*a)), card)
        nbytes, flops = decode_cost("elite_decode_paged", a)
        t_bound, by = bound(nbytes, flops)
        row = dict(tp=tp, nkv=a[2].shape[1], launches=n, max_abs_err=err,
                   ms=time_ms(lambda: ed.elite_decode_paged(*a, split_nkv=nkv),
                              flush=scratch.zero_),
                   plain_ms=time_ms(lambda: ref.elite_decode_paged_ref(*a), flush=scratch.zero_),
                   bound_ms=t_bound, bound_by=by,
                   plan=plan_line(ed.plan_for("elite_decode_paged", a,
                                              ed.sm_count(a[0].device),
                                              ed.smem_optin_limit(a[0].device),
                                              split_nkv=nkv)))
        out["rows"].append(row)
        print(f"[{card}] 3q elite_decode_paged at tp={tp} (nkv {row['nkv']} per shard, "
              f"B={a[0].shape[0]} lengths={a[6].tolist()}): {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({by}), launches "
              f"{n} in the f32 run; {row['plan']}", flush=True)
    del scratch
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3q (tensor-parallel attention) {out['wall']:.1f} s", flush=True)
    return out


# -- tensor-parallel serving (phase 3r) -------------------------------------------
TP_SERVED = ((2, ("plain", "recompute", "prefix", "int8", "spec", "sampled")),
             (4, ("plain", "int8", "spec")))   # (tp, 3p's scenarios served at it)
TP_ROUTED = ("plain", "prefix")                # served by the router at tp 2 x dp 2


def same_rows(label: str, want: dict, got: dict) -> int:
    """Every recorded row (a greedy logits row, or a sampled draw's row and
    token) of a tp run against tp 1's, bit for bit.  → rows compared."""
    import torch
    if set(got) != set(want):
        raise AssertionError(f"{label}: recorded {len(got)} rows, tp 1 {len(want)}; "
                             f"differing keys {sorted(set(got) ^ set(want), key=str)[:8]}")
    bad = []
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple):                        # a draw: (row, token)
            same = torch.equal(g[0], w[0]) and g[1] == w[1]
        elif torch.is_tensor(w):
            same = torch.equal(g, w)
        else:                                           # a residual draw's mark
            same = g == w
        if not same:
            bad.append(k)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(want)} rows differ from tp 1's, "
                             f"first {bad[:4]}")
    return len(want)


def tp_serving(params, buffers, cfg, dev, card: str, handoff: dict) -> dict:
    """Phase 3r: 3p's one-``Scheduler`` runs again through ``Scheduler(mesh=)``
    at tp 2 (every scenario) and tp 4 (plain, int8, spec), and 3p's plain
    and prefix router runs through ``Router(meshes=)`` at tp 2 x dp 2, every
    shard on the card, each held to 3p's run bit for bit; the launcher at
    ``--tp 2`` traced in a fresh process.  → figures."""
    import os
    import torch
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.runtime import sharded_check
    t_phase = time.perf_counter()
    out = {"runs": {}}
    # sharded_check --parity's cases on the card: each *_tp wrapper's kernel
    # launches bitwise equal to the unsharded call's
    parity = sharded_check.run_parity(dev)
    print(f"[{card}] 3r sharded_check --parity on {dev}: {parity}", flush=True)
    if not all(parity.values()):
        raise AssertionError(f"3r parity: {parity}")
    for tp, names in TP_SERVED:
        for name in names:
            t0 = time.perf_counter()
            h = handoff[name]
            rows = {} if h["rows"] is not None else None
            draws = {} if h["draws"] is not None else None
            undo = []
            setup = ((lambda s: undo.append(record_greedy_rows([s], [rows])))
                     if rows is not None else None)
            label = f"3r {name} tp={tp}"
            try:
                rep, launches, _, sched = serve_run(label, params, buffers, cfg, h["scfg"],
                                                    h["make"](), card, setup=setup,
                                                    draws=draws, mesh=TPMesh.on(dev, tp))
            finally:
                for u in undo:
                    u()
            got = {r.uid: list(r.generated) for r in sched.finished}
            if got != h["tokens"]:
                bad = sorted(u for u in h["tokens"] if got.get(u) != h["tokens"][u])
                raise AssertionError(f"{label}: streams {bad} differ from tp 1's")
            counts = (rep.preemptions, rep.prefill_chunks, rep.decode_steps,
                      rep.draft_forwards)
            if counts != h["counts"]:
                raise AssertionError(f"{label}: (preemptions, prefill forwards, decode "
                                     f"steps, draft forwards) {counts} != tp 1's "
                                     f"{h['counts']}")
            n_rows = same_rows(label, h["rows"], rows) if rows is not None else 0
            n_draws = same_rows(label, h["draws"], draws) if draws is not None else 0
            res = dict(tok_s=rep.tok_per_s, ttft=(rep.ttft_wall_p50_ms, rep.ttft_wall_p95_ms),
                       step_p50=rep.step_ms_p50,
                       bpt_dev=sched.pool.bytes_per_token_per_device(),
                       one_bpt_dev=h["bpt_dev"],
                       launches={k: v for k, v in launches.items() if v},
                       rows=n_rows, draws=n_draws, wall=time.perf_counter() - t0)
            out["runs"][name, tp] = res
            print(f"[{card}] {label}: {len(got)} streams, {n_rows} greedy rows and {n_draws} "
                  f"draws bitwise tp 1's; preemptions {counts[0]}, {counts[1]} prefill "
                  f"forwards, {counts[2]} decode steps as tp 1; launches {res['launches']}; "
                  f"{res['wall']:.1f} s", flush=True)
            del sched, rows, draws
    for name in TP_ROUTED:
        t0 = time.perf_counter()
        h = handoff[name]["router"]
        rows = [{}, {}]
        label = f"3r {name} tp=2 dp=2"
        rep, router = router_run(label, params, buffers, cfg, handoff[name]["scfg"],
                                 handoff[name]["make"](), dev, card, rows=rows,
                                 meshes=[TPMesh.on(dev, 2), TPMesh.on(dev, 2)])
        if router.finished_tokens() != h["tokens"] or rep.routed != h["routed"]:
            raise AssertionError(f"{label}: streams or routing {rep.routed} differ from "
                                 f"3p's dp=2 router ({h['routed']})")
        counts = [(r.preemptions, r.prefill_chunks, r.decode_steps) for r in rep.replicas]
        if counts != h["counts"]:
            raise AssertionError(f"{label}: replicas' (preemptions, prefill forwards, decode "
                                 f"steps) {counts} != 3p's {h['counts']}")
        n_rows = sum(same_rows(f"{label} replica {i}", w, g)
                     for i, (w, g) in enumerate(zip(h["rows"], rows)))
        res = dict(tok_s=rep.tok_per_s, ttft=(rep.ttft_wall_p50_ms, rep.ttft_wall_p95_ms),
                   step_p50=[r.step_ms_p50 for r in rep.replicas],
                   bpt_dev=router.replicas[0].pool.bytes_per_token_per_device(),
                   launches=rep.launches, rows=n_rows, wall=time.perf_counter() - t0)
        out["runs"][name, "2x2"] = res
        print(f"[{card}] {label}: streams, routing {rep.routed} and {n_rows} greedy rows "
              f"bitwise 3p's dp=2 router; launches per replica {rep.launches}; "
              f"{res['wall']:.1f} s", flush=True)
        del router, rows
    # the launcher in a fresh process (no kernel loaded yet), traced
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    cli = out_dir / "tp_cli"
    card_dev = str(torch.empty(0, device=dev).device)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--elitekv", "--stream", "--tp", "2",
         "--device", card_dev, "--requests", "6", "--prompt-len", "64", "--new-tokens", "8",
         "--prefill-chunk", "64", "--trace", f"{cli}.json", "--metrics-out", f"{cli}.prom"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if run.returncode or "stream [tp=2]: completed=6" not in run.stdout \
            or "pool/device: " not in run.stdout:
        raise AssertionError(f"3r launch/serve.py --tp 2 --trace: rc {run.returncode}\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    chk = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), f"{cli}.json",
                          "--metrics", f"{cli}.prom"], capture_output=True, text=True,
                         timeout=300)
    if chk.returncode:
        raise AssertionError(f"3r launcher trace: check_trace failed\n{chk.stdout[-3000:]}")
    pool_line = next(x for x in run.stdout.splitlines() if x.startswith("pool/device: "))
    print(f"[{card}] 3r launch/serve.py --stream --tp 2 --device {card_dev} --trace in a fresh "
          f"process: {run.stdout.splitlines()[0]}; {pool_line}; "
          f"{chk.stdout.strip().splitlines()[-1]}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3r (tensor-parallel serving) {out['wall']:.1f} s", flush=True)
    return out


# -- the dense architectures' widths (phases 1, 2) -----------------------------

# the architectures beyond phase 1's two widths whose decode and verify plans
# phase 1 prints, at half and a quarter cache (LLaMA2-7B at half only: its
# quarter is above)
PLAN_ARCHS = ("llama2_7b", "llama2_13b", "yi_6b", "granite_3_2b", "minicpm_2b",
              "qwen3_moe_235b", "jamba_v0_1_52b", "arctic_480b")
# (arch, ratio) whose decode and verify kernels phase 2 holds to the plain
# versions: 40 kv heads at 2r = 64, d_c = 2560 (verify cuts its window), 36
# kv heads at 2r = 16, d_c = 512, and the MoE/hybrid attention widths at a
# quarter cache: Qwen3-MoE (4 kv heads of 16 queries, 2r = 32, d_c = 128),
# Jamba (8 of 4, d_c = 256) and Arctic (8 of 7, d_c = 256)
PARITY_ARCHS = (("llama2_13b", 0.5), ("minicpm_2b", 0.25), ("qwen3_moe_235b", 0.25),
                ("jamba_v0_1_52b", 0.25), ("arctic_480b", 0.25))


def arch_widths(arch: str, ratio: float):
    """(G, n_kv, 2r, d_ckv, d_h) of ``arch`` under EliteKV at ``ratio``
    (``pick_dims``); S-LRD splits d_ckv into two streams of half each."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import pick_dims
    cfg = get_config(arch)
    e = pick_dims(cfg, ratio)
    return cfg.q_group, cfg.n_kv_heads, 2 * e.elite_r, e.d_ckv, cfg.head_dim


def arch_plans(limit: int, sms: int) -> list:
    """Print the decode and verify plans (8 lanes, 72 tiles) of PLAN_ARCHS at
    ratios 0.5 and 0.25, J-LRD and S-LRD, f32 and int8, W = 1, 5 and 9; each
    plan's shared memory must be the kernel source's layout for its part of
    the window.  → [(arch, ratio, lrd, dtype, W, parts)] of the cut windows."""
    from repro_torch.kernels import elite_decode as ed
    cuts = []
    for arch in PLAN_ARCHS:
        for ratio in ((0.5,) if arch == "llama2_7b" else (0.5, 0.25)):
            G, nkv, r2, dcj, _ = arch_widths(arch, ratio)
            for sep in (False, True):
                dc = dcj // 2 if sep else dcj
                for q8 in (False, True):
                    lrd, dt = "S-LRD" if sep else "J-LRD", "int8" if q8 else "f32"
                    cells = []
                    for w in (1, 5, 9):
                        p = ed.plan(8, w, G, nkv, 16, r2, dc, not sep, q8, 72, sms, limit)
                        built = ed.smem_bytes_built(p.part, G, p.heads, 16, r2, dc, not sep,
                                                    q8, p.stages)
                        if built != p.smem:
                            raise AssertionError(f"{arch} W={w}: smem formula {p.smem} B "
                                                 f"!= kernel's {built} B")
                        cut = ""
                        if p.parts > 1:
                            cut = f" cut into {p.parts} parts of {p.part}"
                            cuts.append((arch, ratio, lrd, dt, w, p.parts))
                        cells.append(f"W={w}: {p.heads} kv heads x {p.part} positions "
                                     f"({p.part * G * p.heads} rows)/CTA{cut}, {p.stages} "
                                     f"stages, {p.smem} B, {p.splits} splits of "
                                     f"{p.tiles_per_split}, {p.ctas} CTAs")
                    print(f"  plan {arch} {ratio} {lrd} {dt} (G={G}, {nkv} kv heads, "
                          f"2r={r2}, d_c={dc}): " + "; ".join(cells))
    return cuts


def arch_parity(dev, card: str, errs: dict) -> None:
    """Phase 2 at PARITY_ARCHS' widths: every decode entry (J-LRD and S-LRD)
    and both verify entries at W = 1, 3, 5 and 9 against their plain
    versions, empty lanes exact zeros; LLaMA2-13B's f32 verify at W = 5 and
    int8 at W = 3 must plan a cut window.  Then a forced cut at LLaMA2-7B's
    quarter-cache widths (where the uncut call fits) must give the uncut
    call's bits, row for row, f32 and int8."""
    import torch
    from repro_torch.kernels import elite_decode as ed
    limit, sms = ed.smem_optin_limit(dev), ed.sm_count(dev)
    for i, (arch, ratio) in enumerate(PARITY_ARCHS):
        G, nkv, r2, dcj, dh = arch_widths(arch, ratio)
        nh = G * nkv
        for separate in (False, True):
            lrd = "S-LRD" if separate else "J-LRD"
            dc = dcj // 2 if separate else dcj
            x = random_decode(dev, nh, nkv, r2, dc, separate, seed=60 + i)
            sel = random_selection(x, W=24, seed=60 + i)
            for name in DECODES:
                a = decode_call(name, x, dh, sel)
                got = run_decode(name, a)
                errs[name] = max(errs[name], check(
                    f"{name} {arch} {ratio} {lrd}",
                    max_err(got, run_decode(name, a, plain=True)), card))
                if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                    raise AssertionError(f"{name}: an empty lane did not give exact zeros")
            for W in (1, 3, 5, 9):
                xv = random_verify(dev, nh, nkv, r2, dc, separate, W, seed=70 + W + i)
                for name in VERIFIES:
                    a = decode_call(name, xv, dh)
                    p = ed.plan_for(name, a, sms, limit)
                    must = arch == "llama2_13b" and not separate and (
                        (name.endswith("q8") and W >= 3) or W >= 5)
                    if must and p.parts == 1:
                        raise AssertionError(f"{name} {arch} W={W}: the window was not cut")
                    got = run_decode(name, a)
                    errs[name] = max(errs[name], check(
                        f"{name} W={W} {arch} {ratio} {lrd} ({p.parts} window parts of "
                        f"{p.part}, {p.heads} kv heads/CTA)",
                        max_err(got, run_decode(name, a, plain=True)), card))
                    if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                        raise AssertionError(f"{name}: a dead lane did not give exact zeros")
    G, nkv, r2, dc, dh = arch_widths("llama2_7b", 0.25)
    for separate in (False, True):
        xv = random_verify(dev, G * nkv, nkv, r2, dc, separate, 5, seed=80)
        for name in VERIFIES:
            a = decode_call(name, xv, dh)
            fn = getattr(ed, name)
            whole = fn(*a)
            for part in (1, 2, 3):
                cut = fn(*a, part=part)
                torch.cuda.synchronize()
                if not torch.equal(cut, whole):
                    raise AssertionError(f"{name}: a window cut into parts of {part} "
                                         f"differs from the uncut call (llama2_7b 0.25)")
            print(f"[{card}] {name} W=5 llama2_7b 0.25 {'S' if separate else 'J'}-LRD: "
                  f"windows cut into parts of 1, 2 and 3 positions == the uncut call "
                  f"bitwise", flush=True)


# -- conversion and a tied-embedding model (phases 3i, 3j) -----------------------

CALIB = (4, 512)            # calibration batch: lanes x tokens, random tokens
ELITE_R = 8                 # the search's r: pick_dims' at a quarter cache
EXACT_TOL = 1e-3            # exact-rank model vs partial-RoPE baseline (the reference's)
MINICPM_LAYERS = 40         # MiniCPM-2B's depth, all of it


def conversion(dev, card: str) -> dict:
    """Phase 3i: the paper's conversion of a baseline TinyLlama-1.1B at full
    width (3f's seeded GQA model) and the converted model served.  Capture
    and a greedy RoPElite search at r = 8 on 4 x 512 random calibration
    tokens (counts set to 0 before, read after: ``rope_elite`` once per
    layer in the capture forward and once per layer in the search, nothing
    else); (a) layers 0 and 21 searched again on the CPU, sets equal apart
    from float64 ties; (c) greedy, uniform and contribution distances per
    layer, greedy <= both x 1.001 on layer 0; conversion at d_ckv = 64
    (``pick_dims(0.25)``) and at exact rank 448; (b) the exact-rank model's
    logits, ``apply_train`` and a paged prefill through the kernels, equal
    the partial-RoPE baseline's within 1e-3; (d) the d_ckv = 64 model
    serves 8 greedy requests through the ``Scheduler`` (its kernels 22
    times per forward, nothing else) and its streams equal lockstep
    ``generate``'s apart from near-ties.  → ((e) the times, s, and the
    d_ckv = 64 model (params, buffers, cfg), which phase 3k uptrains)."""
    import numpy as np
    import torch
    from repro_torch.configs import EliteKVConfig
    from repro_torch.core import convert, ropelite
    from repro_torch.core.cache import PagedKVPool
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_config
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    from conversion_checks import compare_sets, subset_rope_logits
    t_phase = time.perf_counter()
    cfg = build_config("tinyllama_1_1b", reduced=False, cache_ratio=0.25, elitekv=False)
    L, G, nkv, dh, theta = (cfg.num_layers, cfg.q_group, cfg.n_kv_heads, cfg.head_dim,
                            cfg.rope_theta)
    params, buffers = lm.init(cfg, seed=0, device=dev)
    calib = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, CALIB)).to(dev)
    pos = torch.arange(CALIB[1], device=dev)
    times = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    caps = lm.capture_attn_inputs(params, buffers, cfg, calib)
    torch.cuda.synchronize()
    times["capture"] = time.perf_counter() - t0
    sets, per_layer = {}, []
    for li, x in caps.items():
        t0 = time.perf_counter()
        q, k = ropelite.layer_qk(params["layers"][li]["attn"], x)
        sets[li] = ropelite.greedy_search_layer(q, k, pos, theta, G, ELITE_R)
        torch.cuda.synchronize()
        per_layer.append(time.perf_counter() - t0)
    launches = {k: v for k, v in ops.launches().items() if v}
    print(f"conversion search launches: {launches} (capture and search, {L} layers)")
    if launches != {"rope_elite": 2 * L}:
        raise AssertionError(f"conversion search: launches {launches}, expected "
                             f"{{'rope_elite': {2 * L}}}")
    times["search"] = sum(per_layer)
    print(f"[{card}] capture of {CALIB[0]} x {CALIB[1]} calibration tokens, {L} layers: "
          f"{times['capture']:.3f} s; greedy search r={ELITE_R} per layer (s): "
          + " ".join(f"{t:.3f}" for t in per_layer), flush=True)
    # (a) layers 0 and L-1 again on the CPU
    ties = 0
    for li in (0, L - 1):
        q, k = ropelite.layer_qk(params["layers"][li]["attn"], caps[li])
        t0 = time.perf_counter()
        cpu = ropelite.greedy_search_layer(q.cpu(), k.cpu(), pos.cpu(), theta, G, ELITE_R)
        times[f"cpu search layer {li}"] = time.perf_counter() - t0
        ties += compare_sets(f"search layer {li} card vs CPU", sets[li], cpu, q, k, theta,
                             G, report=lambda m: print(f"[{card}] {m}", flush=True))
    print(f"[{card}] greedy sets of layers 0 and {L - 1}: card == CPU apart from {ties} "
          f"float64 ties; CPU search {times['cpu search layer 0']:.2f} s and "
          f"{times[f'cpu search layer {L - 1}']:.2f} s per layer", flush=True)
    # (c) the three selection methods' distances, layer by layer
    uniform = ropelite.uniform_selection(dh // 2, ELITE_R, nkv, dev)
    dists = []
    for li, x in caps.items():
        q, k = ropelite.layer_qk(params["layers"][li]["attn"], x)
        by = {"greedy": sets[li], "uniform": uniform,
              "contribution": ropelite.contribution_selection(q, k, G, ELITE_R)}
        dists.append({m: float(ropelite.score_distance(q, k, pos, theta, G, s).sum())
                      for m, s in by.items()})
    print(f"[{card}] score_distance per layer, greedy / uniform / contribution: " + "; ".join(
        f"L{li} {d['greedy']:.4e}/{d['uniform']:.4e}/{d['contribution']:.4e}"
        for li, d in enumerate(dists)), flush=True)
    d0 = dists[0]
    if not (d0["greedy"] <= d0["uniform"] * 1.001 and
            d0["greedy"] <= d0["contribution"] * 1.001):
        raise AssertionError(f"layer 0: greedy {d0} is not <= the baselines x 1.001")
    del caps
    # conversion at a quarter cache and at exact rank
    e64 = convert.pick_dims(cfg, 0.25)
    exact = EliteKVConfig(enabled=True, elite_r=ELITE_R,
                          d_ckv=nkv * (dh - 2 * ELITE_R) + nkv * dh)
    assert (e64.elite_r, e64.d_ckv, exact.d_ckv) == (ELITE_R, 64, 448), (e64, exact)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp, cb, ccfg = convert.convert_model(params, buffers, cfg, sets, e64)
    torch.cuda.synchronize()
    times["convert d_ckv=64"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xp, xb, xcfg = convert.convert_model(params, buffers, cfg, sets, exact)
    torch.cuda.synchronize()
    times["convert d_ckv=448"] = time.perf_counter() - t0
    # (b) exact rank == the partial-RoPE baseline
    V = cfg.vocab_size
    toks = calib[:2, :256]
    want = subset_rope_logits(params, cfg, sets, toks)[..., :V]
    got = lm.apply_train(xp, xb, xcfg, toks)[..., :V]
    B, S = toks.shape
    pool = PagedKVPool(xcfg, B * -(-S // 16), 16, device=dev)
    for b in range(B):
        pool.ensure_capacity(b, S)
    sm = np.stack([pool.prefill_slot_mapping(b, 0, S, S) for b in range(B)])
    ops.reset_launches()
    paged = lm.apply_prefill_paged(xp, xb, xcfg, toks, pool.pages, torch.from_numpy(sm))
    torch.cuda.synchronize()
    plaunch = {k: v for k, v in ops.launches().items() if v}
    if plaunch != {"flash_prefill": L, "rope_elite": L}:
        raise AssertionError(f"exact-rank paged prefill launches {plaunch}")
    errs = {}
    for label, x in (("apply_train", got), ("paged prefill", paged[..., :V])):
        errs[label] = float((x - want).abs().max())
        if not torch.allclose(x, want, atol=EXACT_TOL, rtol=EXACT_TOL):
            raise AssertionError(f"exact-rank {label}: max |logits diff| {errs[label]} past "
                                 f"{EXACT_TOL} + {EXACT_TOL}·|want|")
    print(f"[{card}] exact-rank (d_ckv=448) converted TinyLlama-1.1B vs the baseline with "
          f"RoPE on the elite sets, {B} x {S} tokens: max |logits diff| apply_train "
          f"{errs['apply_train']:.3e}, paged prefill through the kernels "
          f"{errs['paged prefill']:.3e} (launches {plaunch}); tolerance {EXACT_TOL} abs + "
          f"rel", flush=True)
    del xp, xb, pool, want, got, paged
    # (d) the d_ckv = 64 model serves
    n_new = 64
    prompts = np.random.default_rng(13).integers(0, V, (8, 256)).astype(np.int32)
    reqs = [serve_loop.Request(uid=i, prompt=prompts[i], max_new_tokens=n_new)
            for i in range(8)]
    scfg = serve_loop.SchedulerConfig(max_slots=8, block_size=16, num_blocks=8 * 24,
                                      max_new_tokens=n_new, max_len=1024,
                                      prefill_chunk_tokens=256, prefill_batch_lanes=8)
    rep, _, _, sched = serve_run("converted TinyLlama-1.1B d_ckv=64, 8 requests", cp, cb,
                                 ccfg, scfg, reqs, card)
    out, _, _, _, _ = generate_run(
        "converted TinyLlama-1.1B generate", cp, cb, ccfg, prompts, n_new,
        {"elite_decode": L * (n_new - 1), "flash_prefill": L, "rope_elite": L * n_new}, card)
    compare_streams("converted: Scheduler vs lockstep generate",
                    [(r.uid, r.prompt, r.generated, out[r.uid]) for r in sched.finished],
                    cp, cb, ccfg, dev, card, against="generate's")
    del params, buffers
    times["phase"] = time.perf_counter() - t_phase
    times["conversion"] = (times["capture"] + times["search"] + times["convert d_ckv=64"])
    times["step_ms p50"] = rep.step_ms_p50
    print(f"[{card}] conversion times (s): capture {times['capture']:.3f}, search "
          f"{times['search']:.3f} ({times['search'] / L:.3f} per layer), SVDs and surgery "
          f"d_ckv=64 {times['convert d_ckv=64']:.3f}, d_ckv=448 "
          f"{times['convert d_ckv=448']:.3f}; capture + search + convert "
          f"{times['conversion']:.3f}; the whole phase {times['phase']:.1f}", flush=True)
    return times, (cp, cb, ccfg)


# -- training (phase 3k) -----------------------------------------------------------

# 4 steps (8 until phase 3s took their time; depth only)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 4
# the checked run's lr, and the paper's printed beside it: random weights
# under Adam's sign-like first steps spike at 3e-4 with no warmup (PERF.md,
# PR 22), which a converted pretrained model would not
TRAIN_LR, LR_SWEEP = 1e-5, (3e-4,)
RESUME_AT = 2
RESUME_RTOL = 1e-4          # resumed vs uninterrupted losses (atomics reorder sums)
GRAD_RTOL = 1e-4            # card vs CPU gradient, of the leaf's largest (f32 orders)
# the rotation's backward at the uptraining path's widths, (query heads, key
# heads, frequency rows, 2r, projection width, B, S, per-lane positions):
# TinyLlama-1.1B EliteKV (q_e a slice of the projection), LLaMA2-13B at half
# cache (40 rows of 32 pairs: row blocks), TinyLlama's baseline full RoPE
ROPE_BWD_CASES = {"TinyLlama EliteKV q[..., :16] of 64": (32, 4, 4, 16, 64, 8, 512, False),
                  "LLaMA2-13B half cache, row blocks": (40, 40, 40, 64, 128, 2, 257, True),
                  "TinyLlama baseline full RoPE": (32, 4, 1, 64, 64, 8, 512, False)}


def rope_backward_parity(dev, card: str) -> float:
    """Phase 3k (a): the gradient through ``ops.rope_elite_qk`` on the card
    (its backward one launch of the kernel's transpose mode) against
    autograd through the plain version on the same inputs, into the
    projection a strided q was sliced from; tolerance ``ROPE_ATOL`` +
    ``ROPE_RTOL``·|plain|, bitwise-equal share printed.  → max abs error."""
    import torch
    from repro_torch.core import rope
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for label, (Hq, Hk, rows, r2, wide, B, S, per_lane) in ROPE_BWD_CASES.items():
        g = torch.Generator(device=dev).manual_seed(60)
        if rows == 1:
            freqs = rope.chunk_freqs(r2, 10000.0, device=dev)[None]
        else:
            freqs = torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=dev))
            freqs[:, 0] = 1.0
        proj = torch.randn(B, S, Hq, wide, generator=g, device=dev)
        k0 = torch.randn(B, S, Hk, r2, generator=g, device=dev)
        gq = torch.randn(B, S, Hq, r2, generator=g, device=dev)
        gk = torch.randn(B, S, Hk, r2, generator=g, device=dev)
        pos = torch.randint(0, S, (B, S) if per_lane else (S,), generator=g, device=dev)
        grads = {}
        for name, fn in (("kernel", ops.rope_elite_qk), ("plain", ref.rope_elite_qk_ref)):
            p, k = proj.clone().requires_grad_(True), k0.clone().requires_grad_(True)
            before = ops.launches()["rope_elite_backward"]
            qo, ko = fn(p[..., :r2], k, pos, freqs, Hq // rows, Hk // rows)
            d_p, d_k = torch.autograd.grad((qo * gq).sum() + (ko * gk).sum(), (p, k))
            torch.cuda.synchronize()
            if ops.launches()["rope_elite_backward"] != before + (name == "kernel"):
                raise AssertionError(f"rope backward {label}: {name} launched "
                                     f"{ops.launches()['rope_elite_backward'] - before}")
            if d_p[..., r2:].any():
                raise AssertionError(f"rope backward {label}: gradient outside the slice")
            grads[name] = (d_p[..., :r2], d_k)
        e, bad, same = rope_err(grads["kernel"], grads["plain"])
        print(f"[{card}] parity rope_elite_qk backward {label} (q {Hq} x {r2} of {wide}, "
              f"k {Hk}, {rows} rows, B={B} S={S}, pos {'[B,S]' if per_lane else '[S]'}): "
              f"max_abs_err={e:.3e}, {bad} outside {ROPE_ATOL:.0e} + "
              f"{ROPE_RTOL:.0e}·|plain|, bitwise equal {100 * same:.2f}%", flush=True)
        if bad:
            raise AssertionError(f"rope backward {label}: {bad} elements past the tolerance")
        worst = max(worst, e)
    return worst


def card_vs_cpu_gradients(dev, card: str) -> None:
    """Phase 3k (b): a 2-layer TinyLlama-1.1B EliteKV at full width (r 8,
    d_ckv 64), B 2 x S 256, through ``grads_card_vs_cpu``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.serve import build_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(build_config("tinyllama_1_1b", reduced=False,
                                           cache_ratio=0.25), num_layers=2)
    params, buffers = lm.init(cfg, seed=5, device=dev)
    toks = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 257)))
    grads_card_vs_cpu("2-layer full-width", params, buffers, cfg,
                      {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev, card)


def grads_card_vs_cpu(label: str, params, buffers, cfg, batch, dev, card: str) -> None:
    """Every leaf's loss gradient of ``batch`` (CPU tensors) on the card
    (through the rotary kernel forward and backward) against the port's on
    the CPU (plain versions) within ``GRAD_RTOL`` of the leaf's largest +
    1e-7; ``wk_e`` must get a gradient that is not zero."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import items, map_tree
    grads = {}
    for where in ("cpu", dev):
        p = map_tree(lambda t: t.detach().to(where).requires_grad_(True), params)
        b = map_tree(lambda t: t.to(where), buffers)
        t0 = time.perf_counter()
        loss, _ = lm.loss_fn(p, b, cfg, {k: v.to(where) for k, v in batch.items()})
        names, leaves = zip(*items(p))
        grads[str(where)] = dict(zip(names, (g.cpu() for g in
                                             torch.autograd.grad(loss, leaves))))
        del p, b
        print(f"[{card}] {label} loss and gradient on {where}: loss "
              f"{float(loss.detach()):.6f}, {time.perf_counter() - t0:.2f} s", flush=True)
    worst = (0.0, "")
    for name, want in grads["cpu"].items():
        got = grads[str(dev)][name]
        ratio = float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)
        worst = max(worst, (ratio, name))
        if float((got - want).abs().max()) > GRAD_RTOL * float(want.abs().max()) + 1e-7:
            raise AssertionError(f"gradient {name}: card vs CPU {ratio:.3e} of its largest")
    wk = grads[str(dev)]["layers/0/attn/wk_e"]
    if not float(wk.abs().max()) > 0:
        raise AssertionError("wk_e got no gradient on the card")
    print(f"[{card}] {label} gradients, card vs CPU, {len(grads['cpu'])} leaves: "
          f"worst max|Δ| / max|g| {worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL}; "
          f"wk_e max|g| {float(wk.abs().max()):.3e}", flush=True)


def model_flops(params, cfg, B: int, S: int) -> int:
    """Model FLOPs of one training step (forward and backward, no remat):
    6 per weight that multiplies (all but the embedding table) per token,
    and the attention scores and mix, 12·S²·nh·dh per layer and lane."""
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(params)) - params["embed"]["table"].numel()
    return 6 * n * B * S + 12 * cfg.num_layers * B * S * S * cfg.n_heads * cfg.head_dim


def training(dev, card: str, params, buffers, cfg) -> dict:
    """Phase 3k: (a) the rotation's backward kernel against the plain
    autograd; (b) card vs CPU gradients of a 2-layer full-width model; (c)
    the converted 22-layer TinyLlama-1.1B of phase 3i uptrained for
    ``TRAIN_STEPS`` AdamW steps at B 8 x S 512, lr ``TRAIN_LR`` constant,
    full remat (and printed beside it, unchecked, at the larger
    ``LR_SWEEP``): each step must launch the rotation 2 x 22 times forward (forward
    and recompute) and 22 times backward and nothing else, the loss must
    stay finite and end below where it began; step ms, tokens/s, peak
    memory and the model-FLOP share of 67 TFLOP/s are printed; (d)
    ``RESUME_AT`` steps with a checkpoint there and a restart to
    ``TRAIN_STEPS``, whose losses must equal
    the uninterrupted run's within ``RESUME_RTOL``; (e) the uptrained weights
    serve 8 x (256 + 64) greedy through the ``Scheduler``, streams equal to
    lockstep ``generate``'s apart from near-ties.  → the numbers and the
    backward's recorded inputs."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rope_elite as re_k
    from repro_torch.runtime import serve_loop, train_loop
    t_phase = time.perf_counter()
    out = {"rope_err": rope_backward_parity(dev, card)}
    card_vs_cpu_gradients(dev, card)
    L = cfg.num_layers
    assert (L, cfg.d_model, cfg.elitekv.elite_r, cfg.elitekv.d_ckv) == (NUM_LAYERS, 2048, 8, 64)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                    batch_size=TRAIN_B, seed=21), device=dev)
    t0 = time.perf_counter()
    batches = [next(pipe) for _ in range(TRAIN_STEPS)]
    print(f"[{card}] {TRAIN_STEPS} batches of {TRAIN_B} x {TRAIN_S} synthetic tokens made in "
          f"{time.perf_counter() - t0:.2f} s (host, before the timed runs)", flush=True)
    per_step = {"rope_elite": 2 * L, "rope_elite_backward": L}

    def run(label, num_steps, lr=TRAIN_LR, **kw):
        losses, stamps, seen = {}, [], {}

        def cb(step, metrics):
            losses[step] = float(metrics["loss"])          # waits for the step
            stamps.append(time.perf_counter())
            n = ops.launches()
            got = {k: n[k] - seen.get(k, 0) for k in n if n[k] - seen.get(k, 0)}
            seen.update(n)
            if got != per_step:
                raise AssertionError(f"{label} step {step}: launches {got}, "
                                     f"expected {per_step}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        stamps.append(time.perf_counter())
        p, _, _ = train_loop.train(params, buffers, cfg, train_loop.TrainConfig(lr=lr),
                                   iter(batches), num_steps, log_every=0, callback=cb, **kw)
        launches = {k: v for k, v in ops.launches().items() if v}
        return p, losses, np.diff(stamps) * 1e3, launches

    # c. the uninterrupted run, keeping the first rotation's arguments
    first, rotate = [], ops.rope_elite_qk
    ops.rope_elite_qk = lambda *a: (first.append(a) if not first else None, rotate(*a))[1]
    try:
        up, losses, step_ms, launches = run("uptraining", TRAIN_STEPS)
    finally:
        ops.rope_elite_qk = rotate
    peak = torch.cuda.max_memory_allocated(dev)
    vals = [losses[s] for s in range(TRAIN_STEPS)]
    if not (np.isfinite(vals).all() and vals[-1] < vals[0]):
        raise AssertionError(f"uptraining losses {vals}: not finite or not falling")
    p50 = float(np.percentile(step_ms[1:], 50))
    flops = model_flops(params, cfg, TRAIN_B, TRAIN_S)
    out.update(losses=vals, step_ms=step_ms, step_ms_p50=p50, peak_bytes=peak,
               launches=launches, flops=flops,
               tok_s=TRAIN_B * TRAIN_S / (p50 / 1e3), mfu=flops / (p50 / 1e3) / PEAK_F32_FLOPS)
    print(f"[{card}] uptraining converted TinyLlama-1.1B (r 8, d_ckv 64, 22 layers), B "
          f"{TRAIN_B} x S {TRAIN_S}, AdamW f32 lr {TRAIN_LR} constant, full remat, TF32 off: "
          f"losses " + " ".join(f"{v:.4f}" for v in vals), flush=True)
    print(f"[{card}] uptraining step ms: " + " ".join(f"{t:.1f}" for t in step_ms)
          + f"; p50 (steps 1-{TRAIN_STEPS - 1}) {p50:.1f} ms, {out['tok_s']:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.2f} GiB, model FLOPs {flops:.4e} per step = "
          f"{100 * out['mfu']:.1f}% of 67 TFLOP/s at the p50; rotation launches per step "
          f"{per_step} (total {launches})", flush=True)
    for lr in LR_SWEEP:
        _, sweep, sweep_ms, _ = run(f"uptraining at lr {lr}", TRAIN_STEPS, lr=lr)
        print(f"[{card}] the same run at lr {lr} (not checked): losses "
              + " ".join(f"{sweep[s]:.4f}" for s in range(TRAIN_STEPS)) + "; step ms p50 "
              f"{float(np.percentile(sweep_ms[1:], 50)):.1f}", flush=True)
    # the backward's inputs at the main path's shapes and strides: q's
    # gradient is the slice [..., :2r] of the [B, S, nh, dh] gradient of
    # [q_e | q_ne], k's a contiguous [B, S, nkv, 2r]; positions and freqs
    # from a recorded rotation of the run
    q, k, pos, freqs, qpr, kpr = first.pop()
    g = torch.Generator(device=dev).manual_seed(61)
    gq = torch.randn(q.shape[:3] + (cfg.head_dim,), generator=g, device=dev)[..., :q.shape[-1]]
    gk = torch.randn(tuple(k.shape), generator=g, device=dev)
    out["bwd_args"] = a = (gq, gk, pos, freqs, qpr, kpr)
    del q, k
    e, bad, same = rope_err(re_k.rope_elite_backward(*a),
                            ref.rope_elite_qk_ref(*a, transpose=True))
    print(f"[{card}] parity rope_elite_backward at the uptraining step's shapes (g_q "
          f"{tuple(gq.shape)} stride {gq.stride()}, g_k {tuple(gk.shape)}) against "
          f"rope_elite_qk_ref(transpose=True): max_abs_err={e:.3e}, {bad} outside the "
          f"tolerance, bitwise equal {100 * same:.2f}%", flush=True)
    if bad:
        raise AssertionError(f"rope_elite_backward: {bad} elements past the tolerance")
    out["rope_err"] = max(out["rope_err"], e)
    # d. a checkpoint at step RESUME_AT and a restart
    ck_dir = ROOT / "build" / "ckpt_3k"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = Checkpointer(str(ck_dir), keep_last=1)
    t0 = time.perf_counter()
    run("until the checkpoint", RESUME_AT, checkpointer=ck, ckpt_every=RESUME_AT)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, resumed, _, _ = run("resumed", TRAIN_STEPS, checkpointer=ck, ckpt_every=0)
    t_resume = time.perf_counter() - t0
    ck_bytes = sum(f.stat().st_size for f in ck_dir.rglob("*") if f.is_file())
    shutil.rmtree(ck_dir, ignore_errors=True)
    for s in range(RESUME_AT, TRAIN_STEPS):
        if not abs(resumed[s] - losses[s]) <= RESUME_RTOL * abs(losses[s]):
            raise AssertionError(f"resumed step {s}: loss {resumed[s]} vs uninterrupted "
                                 f"{losses[s]}")
    print(f"[{card}] checkpoint at step {RESUME_AT} ({ck_bytes / 2**30:.2f} GiB on disk; "
          f"{RESUME_AT} steps and the save {t_save:.1f} s) and a restart to {TRAIN_STEPS} "
          f"(restore and {TRAIN_STEPS - RESUME_AT} steps {t_resume:.1f} s): losses "
          + " ".join(f"{resumed[s]:.6f}" for s in range(RESUME_AT, TRAIN_STEPS))
          + f" vs uninterrupted " + " ".join(f"{losses[s]:.6f}"
                                              for s in range(RESUME_AT, TRAIN_STEPS))
          + f", within {RESUME_RTOL} relative", flush=True)
    # e. the uptrained weights served
    n_new = 64
    prompts = np.random.default_rng(16).integers(0, cfg.vocab_size, (8, 256)).astype(np.int32)
    reqs = [serve_loop.Request(uid=i, prompt=prompts[i], max_new_tokens=n_new)
            for i in range(8)]
    scfg = serve_loop.SchedulerConfig(max_slots=8, block_size=16, num_blocks=8 * 24,
                                      max_new_tokens=n_new, max_len=1024,
                                      prefill_chunk_tokens=256, prefill_batch_lanes=8)
    _, _, _, sched = serve_run("uptrained TinyLlama-1.1B, 8 requests", up, buffers, cfg,
                               scfg, reqs, card)
    gen, _, _, _, _ = generate_run(
        "uptrained TinyLlama-1.1B generate", up, buffers, cfg, prompts, n_new,
        {"elite_decode": L * (n_new - 1), "flash_prefill": L, "rope_elite": L * n_new}, card)
    compare_streams("uptrained: Scheduler vs lockstep generate",
                    [(r.uid, r.prompt, r.generated, gen[r.uid]) for r in sched.finished],
                    up, buffers, cfg, dev, card, against="generate's")
    out["phase"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3k (training) {out['phase']:.1f} s", flush=True)
    return out


def tied_model(dev, card: str) -> dict:
    """Phase 3j: MiniCPM-2B (tied embeddings, 36/36 heads of 64, vocab
    122,880) with EliteKV at a quarter cache (r = 8, d_ckv = 512) at full
    width, MINICPM_LAYERS layers of seeded random weights: 6 greedy requests
    plain, then k = 4 speculation with the full-rank draft on the same
    requests; each run launches its kernels MINICPM_LAYERS times per forward
    and nothing else, and the streams must be equal apart from near-ties.
    → the runs' numbers."""
    import dataclasses
    import torch
    from repro_torch.configs import EliteKVConfig, get_config
    from repro_torch.launch.serve import make_stream
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"), num_layers=MINICPM_LAYERS,
                              elitekv=EliteKVConfig(enabled=True, elite_r=8, d_ckv=512))
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    if "lm_head" in params:
        raise AssertionError("a tied model built an lm_head")
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    print(f"[{card}] MiniCPM-2B EliteKV r=8 d_ckv=512, {cfg.num_layers} of 40 layers, tied "
          f"embeddings, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}: "
          f"{nbytes / 2**30:.2f} GiB of f32 weights, init {t_init:.2f} s", flush=True)
    base = dict(max_slots=8, block_size=16, num_blocks=8 * 40, max_new_tokens=64,
                max_len=1024, prefill_chunk_tokens=256, prefill_batch_lanes=8)
    stream = lambda: make_stream(cfg, 6, rate=0.5, prompt_len=512, new_tokens=64, seed=14,
                                 prompt_min=256, new_min=64)
    prep, _, _, psched = serve_run("MiniCPM-2B plain 6 requests", params, buffers, cfg,
                                   serve_loop.SchedulerConfig(**base), stream(), card)
    srep, _, _, ssched = serve_run(
        "MiniCPM-2B spec k=4 r=full 6 requests", params, buffers, cfg,
        serve_loop.SchedulerConfig(**base, speculate_k=4, draft_rank=0), stream(), card)
    compare_streams("MiniCPM-2B spec k=4 r=full", sched_streams(psched, ssched), params,
                    buffers, cfg, dev, card)
    if not srep.acceptance_rate >= 0.99:
        raise AssertionError(f"MiniCPM-2B full-rank draft acceptance {srep.acceptance_rate}")
    del params, buffers
    wall = time.perf_counter() - t_phase
    print(f"[{card}] MiniCPM-2B: plain step_ms p50/p95={prep.step_ms_p50:.2f}/"
          f"{prep.step_ms_p95:.2f} tok/s={prep.tok_per_s:.1f}; spec k=4 step_ms p50="
          f"{srep.step_ms_p50:.2f} acceptance={srep.acceptance_rate:.3f} tokens/forward="
          f"{srep.tokens_per_forward:.2f} tok/s={srep.tok_per_s:.1f}; phase {wall:.1f} s",
          flush=True)
    return {"plain": prep, "spec": srep, "wall": wall, "init": t_init}


# -- MoE, Mamba and hybrid stacks at full width (phase 3l) -----------------------

QWEN_LAYERS = 1             # of Qwen3-MoE-235B's 94 (one layer per period; 4 until
                            # phase 3s took their time)
JAMBA_LAYERS = 8            # one whole period of Jamba-v0.1's 32
MODULE_TOL = 1e-5           # card vs CPU, of the output's largest magnitude (f32)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def moe_vs_cpu(label: str, p, cfg, dev, card: str, seed: int) -> dict:
    """One MoE FFN (``moe.apply``, ragged) on 64 tokens on the card against
    the same params and tokens on the CPU: every token's output within
    MODULE_TOL of the CPU output's largest magnitude, or excused where the
    CPU router's k-th/(k+1)-th gap is under ROUTE_GAP; the balance loss
    within 1e-5 relative unless a token was excused.  → numbers printed."""
    import torch
    from repro_torch.models import moe
    from routing_margins import ROUTE_GAP, recorded_gaps
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator().manual_seed(seed))
    pc = _to(p, "cpu")
    with recorded_gaps([]) as calls:
        want, want_aux = moe.apply(pc, cfg, x)
    del pc
    got, aux = moe.apply(p, cfg, x.to(dev))
    d = (got.cpu() - want).abs().amax(-1)[0]
    tol = MODULE_TOL * float(want.abs().max())
    near = calls[0] < ROUTE_GAP
    excused, bad = int(((d > tol) & near).sum()), int(((d > tol) & ~near).sum())
    aux_rel = abs(float(aux) - float(want_aux)) / float(want_aux)
    print(f"[{card}] card vs CPU {label} (64 tokens, {cfg.n_experts} experts top-"
          f"{cfg.top_k}): max |diff| {float(d.max()):.3e} against tol {tol:.3e}, "
          f"{excused} tokens excused (router gap < {ROUTE_GAP:.0e}; least gap "
          f"{float(calls[0].min()):.3e}), balance loss rel diff {aux_rel:.2e}", flush=True)
    if bad or (not excused and aux_rel > 1e-5):
        raise AssertionError(f"{label}: {bad} tokens past {tol:.3e} with router gaps "
                             f">= {ROUTE_GAP}, balance loss rel diff {aux_rel}")
    return dict(max_d=float(d.max()), excused=excused)


def mamba_vs_cpu(label: str, p, cfg, dev, card: str, seed: int) -> None:
    """One Mamba layer on the card against the CPU on the same params: the
    prefill output and final (conv, ssm) state of 2 x 256 tokens (two scan
    chunks), then 16 decode steps from that state, each output and the
    last state within MODULE_TOL of the CPU's largest magnitude."""
    import torch
    from repro_torch.models import mamba
    x = torch.randn(2, 256 + 16, cfg.d_model, generator=torch.Generator().manual_seed(seed))
    pc = _to(p, "cpu")
    errs = {}

    def cmp(name, got, want):
        e = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        errs[name] = max(errs.get(name, 0.0), e)

    want, (wc, ws) = mamba.apply_full(pc, cfg, x[:, :256], return_state=True)
    got, (gc, gs) = mamba.apply_full(p, cfg, x[:, :256].to(dev), return_state=True)
    cmp("prefill out", got, want)
    cmp("conv state", gc, wc)
    cmp("ssm state", gs, ws)
    ws_, gs_ = {"conv": wc, "ssm": ws}, {"conv": gc, "ssm": gs}
    for t in range(256, 256 + 16):
        want, ws_ = mamba.apply_decode(pc, cfg, x[:, t:t + 1], ws_)
        got, gs_ = mamba.apply_decode(p, cfg, x[:, t:t + 1].to(dev), gs_)
        cmp("decode out", got, want)
    cmp("ssm state after decode", gs_["ssm"], ws_["ssm"])
    print(f"[{card}] card vs CPU {label}: relative max |diff| "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {MODULE_TOL:.0e})",
          flush=True)
    if max(errs.values()) > MODULE_TOL:
        raise AssertionError(f"{label}: card vs CPU {errs} past {MODULE_TOL}")


def record_greedy_rows(scheds: list, rows: list):
    """Keep the logits row every greedy token of each of ``scheds`` (stepped
    one at a time: one scheduler, or a router's replicas) is taken from, in
    ``rows[k]`` for scheduler ``k``, under (uid, token index): the row after
    a completed prefill and each decode step's rows of the decode-ready
    lanes.  → undo."""
    from repro_torch.models import lm
    real, current = lm.apply_decode_paged, [None]

    def decode(*a, **k):
        logits = real(*a, **k)
        s = current[0]
        if s is not None:
            for i, req in enumerate(s.slots):
                if req is not None and s._decode_ready(req):
                    rows[scheds.index(s)][req.uid, len(req.generated)] = \
                        logits[i, -1].clone()
        return logits

    for s, r in zip(scheds, rows):
        def step(s=s, real_step=s.step):
            current[0] = s
            try:
                return real_step()
            finally:
                current[0] = None

        def first(req, last_row, r=r, real_first=s._sample_prefill_token):
            r[req.uid, len(req.generated)] = last_row.clone()
            return real_first(req, last_row)
        s.step, s._sample_prefill_token = step, first
    lm.apply_decode_paged = decode
    return lambda: setattr(lm, "apply_decode_paged", real)


def generate_rows(params, buffers, cfg, prompt, n_new: int, dev):
    """``generate`` of one prompt, keeping each token's logits row and the
    least router gap over the positions its forward routed, prompt included
    (the running minimum).  → (tokens, rows [n_new, Vp], gaps [n_new])."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    from routing_margins import recorded_gaps
    rows = []
    real_p, real_d = lm.apply_prefill, lm.apply_decode

    def keep(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            rows.append(out[0, -1].clone())
            return out
        return run

    lm.apply_prefill, lm.apply_decode = keep(real_p), keep(real_d)
    try:
        with recorded_gaps([]) as calls:
            out, _ = serve_loop.generate(params, buffers, cfg, prompt[None], n_new, device=dev)
    finally:
        lm.apply_prefill, lm.apply_decode = real_p, real_d
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    if not n_moe:                           # no router: nothing to excuse
        return out[0], torch.stack(rows), [float("inf")] * len(rows)
    per_forward = [float(torch.stack([c.min() for c in calls[i:i + n_moe]]).min())
                   for i in range(0, len(calls), n_moe)]
    gaps, least = [], float("inf")
    for g in per_forward:                   # row t comes from forward t
        least = min(least, g)
        gaps.append(least)
    return out[0], torch.stack(rows), gaps


def compare_greedy_rows(label: str, sched, rows: dict, params, buffers, cfg, dev,
                        card: str) -> dict:
    """The ``Scheduler``'s greedy streams against ``generate`` of each
    request alone, through the logits row of every token.  Up to where a
    stream parts, rows must agree within LOGIT_TOL (max abs); a row past it
    is excused only where ``generate``'s routers came within ROUTE_GAP of
    another expert choice on that token's context (then the request is
    compared no further), and a stream may part at a token whose rows agree
    only where the reference row's top-2 margin is within twice their
    difference (a near-tie the difference can flip).  Anything else fails,
    after every request is checked.  → counts."""
    import torch
    from routing_margins import ROUTE_GAP
    st = dict(tokens=0, bitwise=0, max_d=0.0, routing=0, near_tie=0)
    bad = []
    for req in sorted(sched.finished, key=lambda r: r.uid):
        want, grows, gaps = generate_rows(params, buffers, cfg, req.prompt,
                                          req.max_new_tokens, dev)
        got = list(req.generated)
        R = torch.stack([rows[req.uid, t] for t in range(len(got))])
        d = (grows.double() - R.double()).abs().amax(-1).cpu().numpy()
        part = [t for t in range(len(got)) if got[t] != int(want[t]) or d[t] > LOGIT_TOL]
        n = part[0] + 1 if part else len(got)
        st["tokens"] += n
        st["bitwise"] += int((d[:n] == 0).sum())
        st["max_d"] = max(st["max_d"], float(d[:n][d[:n] <= LOGIT_TOL].max(initial=0.0)))
        if not part:
            continue
        t = part[0]
        if d[t] > LOGIT_TOL:
            if gaps[t] < ROUTE_GAP:
                st["routing"] += 1
                print(f"[{card}] {label} request {req.uid}: rows differ by {d[t]:.3e} at "
                      f"token {t}, excused: least router gap {gaps[t]:.3e}", flush=True)
            else:
                bad.append(f"request {req.uid}: rows differ by {d[t]:.3e} > {LOGIT_TOL} at "
                           f"token {t}, least router gap {gaps[t]:.3e}")
            continue
        top = torch.topk(grows[t].double(), 2).values
        margin = float(top[0] - top[1])
        st["near_tie"] += 1
        print(f"[{card}] {label} request {req.uid}: token {t} is {got[t]} against "
              f"{int(want[t])}; rows differ by {d[t]:.3e}, reference margin {margin:.3e}",
              flush=True)
        if not margin <= 2 * d[t] + FLIP_SLACK * float(grows[t].abs().max()):
            bad.append(f"request {req.uid}: parted at token {t} with margin {margin:.3e}")
    print(f"[{card}] {label}: {st['tokens']} tokens' rows compared with generate's: bitwise "
          f"equal {st['bitwise']}, max |logits difference| {st['max_d']:.3e} (limit "
          f"{LOGIT_TOL}); {st['routing']} requests excused by routing, {st['near_tie']} "
          f"parted at near-ties", flush=True)
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return st


def profile_lockstep(params, buffers, cfg, dev, card: str, label: str, stats: dict,
                     B: int = 8, prompt: int = 512, steps: int = 10) -> None:
    """A profiler window over ``steps`` lockstep decode steps of ``B`` lanes
    after a ``prompt``-token prefill and 3 decode steps (``lm.apply_prefill``
    / ``apply_decode`` over ``init_cache``, as ``generate`` runs them)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, B, prompt + steps + 4, device=dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, prompt))).to(dev)
    with torch.no_grad():
        nxt = lm.apply_prefill(params, buffers, cfg, toks, cache)[:, -1].argmax(-1)
        state = {"nxt": nxt}

        def step():
            state["nxt"] = lm.apply_decode(params, buffers, cfg, state["nxt"][:, None],
                                           cache)[:, -1].argmax(-1)
        for _ in range(3):
            step()
        profile_window(step, steps, card, f"{label}: {steps} decode steps x {B} lanes",
                       stats)


def kernel_subrow(label: str, name: str, a, launches: int, card: str, flush,
                  phase: str = "3l") -> dict:
    """One kernel at a recorded 3l (or 3m) input: held to its plain version
    (``check``), timed beside it, its bound (``flash_prefill``'s prefill
    body at the 3xTF32 rate, as phase 4) and SDPA's time where one call
    computes the function (``flash_prefill``; ``elite_decode`` over
    prebuilt operands, as phase 4)."""
    from repro_torch.kernels.elite_decode import contig_decode_cost, decode_cost, visited_rows
    from repro_torch.kernels.flash_prefill import prefill_cost
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ref
    lib, peak = None, PEAK_F32_FLOPS
    if name == "flash_prefill":
        x = dict(q=a[0], k=a[1], v=a[2], G=a[3], scale=a[4], offs=a[5], lens=a[6])
        nbytes, flops = prefill_cost(x["q"], x["k"], x["offs"], x["lens"])
        if fp.plan_for(*a).body == "prefill":
            peak = PEAK_3XTF32_FLOPS
        fn, plain = (lambda: run_prefill(x)), (lambda: run_prefill(x, plain=True))
        lib = time_ms(sdpa_call(x), flush=flush)
        shape = f"q={tuple(x['q'].shape)} k={tuple(x['k'].shape)}"
    elif name == "elite_decode":
        nbytes, flops = contig_decode_cost(a)
        fn, plain = (lambda: ed.elite_decode(*a)), (lambda: ref.elite_decode_ref(*a))
        lib = time_ms(contig_sdpa_call(a), flush=flush)
        shape = f"q_e={tuple(a[0].shape)} k_e={tuple(a[2].shape)} rows {int(a[5].sum())}"
    else:
        nbytes, flops = decode_cost(name, a)
        fn, plain = (lambda: run_decode(name, a)), (lambda: run_decode(name, a, plain=True))
        shape = f"q_e={tuple(a[0].shape)} visited rows {visited_rows(name, a)}"
    err = check(f"{name} at {label}", max_err(fn(), plain()), card)
    t_bound, by = bound(nbytes, flops, peak)
    r = dict(name=name, at=label, launches=launches, max_abs_err=err,
             ms=time_ms(fn, flush=flush), plain_ms=time_ms(plain, flush=flush),
             bound_ms=t_bound, bound_by=by, library_ms=lib)
    print(f"[{card}] {phase} kernel {name} at {label} ({shape}): {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {t_bound:.5f} ms ({by}: {nbytes} B, {flops} flop), "
          f"SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}, launches {launches}",
          flush=True)
    return r


# Falcon-Mamba-7B's layers through generate in 3l: 16 of 64, cut in depth
# to make room for phases 3r (64 → 32; 64 took ~22 s) and 3s (32 → 16)
FALCON_GEN_LAYERS = 16


def moe_mamba_hybrid(dev, card: str) -> dict:
    """Phase 3l: Qwen3-MoE (``QWEN_LAYERS`` full-width layers) through the paged
    ``Scheduler``, one full-width period of Jamba-v0.1 and
    ``FALCON_GEN_LAYERS`` of Falcon-Mamba-7B's 64 layers through
    ``generate``, card vs CPU module checks, and
    the kernels at the new attention shapes.  → numbers for the summary."""
    from repro_torch.kernels.elite_decode import visited_rows
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.cache import model_cache_floats_per_token
    from repro_torch.launch.serve import build_config, make_stream
    from repro_torch.models import lm, moe
    from repro_torch.runtime import serve_loop
    t_phase = time.perf_counter()
    flush = torch.empty(64 * 2**20 // 4, device=dev).zero_       # > the 50 MB L2
    _free_card()
    # what the earlier phases still hold (recorded kernel inputs, pools):
    # part of every peak below
    out = {"subrows": [], "held": torch.cuda.memory_allocated()}
    print(f"[{card}] 3l: {out['held'] / 2**30:.2f} GiB allocated on the card before the "
          f"first model (earlier phases' recorded inputs and pools)", flush=True)

    def weights(params):
        return sum(t.numel() * t.element_size() for t in _tensors(params))

    # a. Qwen3-MoE-235B, QWEN_LAYERS of 94 layers, through the paged Scheduler
    cfg = dataclasses.replace(build_config("qwen3_moe_235b", reduced=False, cache_ratio=0.25),
                              num_layers=QWEN_LAYERS)
    e = cfg.elitekv
    base_cfg = dataclasses.replace(cfg, elitekv=dataclasses.replace(e, enabled=False))
    per_tok, base_tok = (4 * model_cache_floats_per_token(c) for c in (cfg, base_cfg))
    assert (cfg.d_model, cfg.n_experts, cfg.top_k, e.elite_r, e.d_ckv, cfg.n_attn_layers,
            per_tok, base_tok) == (4096, 128, 8, 16, 128, QWEN_LAYERS, 1024 * QWEN_LAYERS,
                                   4096 * QWEN_LAYERS), cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[{card}] 3l a. Qwen3-MoE-235B, {QWEN_LAYERS} of 94 layers at full width: "
          f"{weights(params) / 1e9:.2f} GB of f32 weights made in "
          f"{time.perf_counter() - t0:.1f} s; EliteKV r={e.elite_r} d_ckv={e.d_ckv}: cache "
          f"{per_tok} B per token over the {QWEN_LAYERS} layers against {base_tok} for the "
          f"baseline", flush=True)
    scfg = serve_loop.SchedulerConfig(max_slots=8, block_size=16, num_blocks=8 * 64,
                                      max_new_tokens=128, max_len=1024,
                                      prefill_chunk_tokens=256, prefill_batch_lanes=8)
    reqs = make_stream(cfg, 24, rate=0.5, prompt_len=768, new_tokens=128, seed=0,
                       prompt_min=64, new_min=32)
    rows, undo = {}, []
    syncs = moe.group_size_syncs
    try:
        rep, launches, rec, sched = serve_run(
            "3l Qwen3-MoE f32 24 requests", params, buffers, cfg, scfg, reqs, card,
            setup=lambda s: undo.append(record_greedy_rows([s], [rows])))
    finally:
        for u in undo:
            u()
    syncs = moe.group_size_syncs - syncs
    forwards = rep.decode_steps + rep.prefill_chunks
    if syncs != QWEN_LAYERS * forwards:
        raise AssertionError(f"Qwen3-MoE: {syncs} group-size syncs over {forwards} forwards")
    a = dict(rep=rep, peak=torch.cuda.max_memory_allocated(), syncs=syncs / forwards,
             launches=launches)
    a["cmp"] = compare_greedy_rows("3l Qwen3-MoE Scheduler vs generate", sched, rows,
                                   params, buffers, cfg, dev, card)
    del rows, sched
    a["profile"] = {}
    profile_decode(params, buffers, cfg, dev, card, "3l Qwen3-MoE f32", stats=a["profile"])
    moe_vs_cpu("Qwen3-MoE FFN, layer 0", params["layers"][0]["ffn"], cfg, dev, card, 11)
    calls = rec.calls["elite_decode_paged"]
    busy = max(calls, key=lambda c: visited_rows("elite_decode_paged", c))
    chunk = max(rec.calls["flash_prefill"], key=lambda c: int(c[6].sum()))
    del params, buffers, rec
    _free_card()
    out["subrows"] += [
        kernel_subrow("Qwen3-MoE busiest decode", "elite_decode_paged", busy,
                      launches["elite_decode_paged"], card, flush),
        kernel_subrow("Qwen3-MoE busiest prefill chunk", "flash_prefill", chunk,
                      launches["flash_prefill"], card, flush)]
    del busy, chunk, calls
    out["qwen"] = a

    # b. Jamba-v0.1, one whole period (8 of 32 layers), through generate
    cfg = dataclasses.replace(build_config("jamba_v0_1_52b", reduced=False, cache_ratio=0.25),
                              num_layers=JAMBA_LAYERS)
    e = cfg.elitekv
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(JAMBA_LAYERS)]
    assert (cfg.attn_layer_indices, e.elite_r, e.d_ckv, cfg.n_experts, cfg.top_k) == \
        ((3,), 16, 256, 16, 2), cfg
    assert [k for k, _ in kinds].count("ssm") == 7 and \
        [f for _, f in kinds].count("moe") == 4 == [f for _, f in kinds].count("mlp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[{card}] 3l b. Jamba-v0.1, one period ({JAMBA_LAYERS} of 32 layers: {kinds}) at "
          f"full width: {weights(params) / 1e9:.2f} GB of f32 weights made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B, P, N = 8, 1024, 128
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, P))
    syncs = moe.group_size_syncs
    _, gstats, gwall, grec, glaunches = generate_run(
        "3l generate Jamba period", params, buffers, cfg, prompts, N,
        {"elite_decode": N - 1, "flash_prefill": 1, "rope_elite": N}, card)
    syncs = moe.group_size_syncs - syncs
    if syncs != 4 * N:
        raise AssertionError(f"Jamba: {syncs} group-size syncs over {N} forwards")
    b = dict(stats=gstats, wall=gwall, peak=torch.cuda.max_memory_allocated(), syncs=syncs / N)
    # cache on == cache off on a short prompt
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab_size,
                                                               (2, 68))).to(dev)
    from routing_margins import ROUTE_GAP, min_gap_per_token, recorded_gaps
    with torch.no_grad():
        with recorded_gaps([]) as calls:
            full = lm.apply_train(params, buffers, cfg, toks)
        least = float(min_gap_per_token([c.cpu() for c in calls], 2 * 68).min())
        cache = lm.init_cache(cfg, 2, 68, device=dev)
        d = [float((lm.apply_prefill(params, buffers, cfg, toks[:, :64], cache)
                    - full[:, :64]).abs().max())]
        for t in range(64, 68):
            d.append(float((lm.apply_decode(params, buffers, cfg, toks[:, t:t + 1], cache)
                            - full[:, t:t + 1]).abs().max()))
    del full, cache
    print(f"[{card}] 3l Jamba cache on == cache off, 2 x (64 prefill + 4 decode): max |logits "
          f"difference| prefill {d[0]:.3e}, decode {max(d[1:]):.3e} (limit {LOGIT_TOL}); "
          f"least router gap {least:.3e}", flush=True)
    if max(d) > LOGIT_TOL and not least < ROUTE_GAP:
        raise AssertionError(f"Jamba cache on != cache off: {d}")
    b["cache_d"] = max(d)
    b["profile"] = {}
    profile_lockstep(params, buffers, cfg, dev, card, "3l Jamba period", b["profile"])
    moe_vs_cpu("Jamba MoE FFN, layer 1", params["layers"][1]["ffn"], cfg, dev, card, 14)
    mamba_vs_cpu("Jamba Mamba layer 0", params["layers"][0]["attn"], cfg, dev, card, 15)
    dec = max(grec.calls["elite_decode"], key=lambda c: int(c[5].sum()))
    pre = grec.calls["flash_prefill"][0]
    del params, buffers, grec
    _free_card()
    out["subrows"] += [
        kernel_subrow("Jamba generate decode", "elite_decode", dec,
                      glaunches["elite_decode"], card, flush),
        kernel_subrow("Jamba generate prefill", "flash_prefill", pre,
                      glaunches["flash_prefill"], card, flush)]
    del dec, pre
    out["jamba"] = b

    # c. Falcon-Mamba-7B at full width through generate: no kernel runs
    cfg = build_config("falcon_mamba_7b", reduced=False, cache_ratio=0.25)
    assert (cfg.num_layers, cfg.n_attn_layers, cfg.d_inner, cfg.elitekv.enabled) == \
        (64, 0, 8192, False), cfg
    cfg = dataclasses.replace(cfg, num_layers=FALCON_GEN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[{card}] 3l c. Falcon-Mamba-7B, {FALCON_GEN_LAYERS} of 64 layers: "
          f"{weights(params) / 1e9:.2f} GB of "
          f"f32 weights made in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(16).integers(0, cfg.vocab_size, (B, P))
    _, fstats, fwall, _, _ = generate_run("3l generate Falcon-Mamba", params, buffers, cfg,
                                          prompts, N, {}, card)
    out["falcon"] = dict(stats=fstats, wall=fwall, peak=torch.cuda.max_memory_allocated())
    del params, buffers
    _free_card()
    out["wall"] = time.perf_counter() - t_phase
    return out


# -- the vision and audio frontends at full width (phase 3m) ----------------------

FRONT_PATCHES, FRONT_TEXT = 256, 256   # InternVL2: patch embeddings, then text tokens
FRONT_LANES, FRONT_DECODE = 8, 64      # paged prefill lanes and greedy decode steps
MUSIC_LANES, MUSIC_FRAMES, MUSIC_DECODE = 4, 512, 32
MUSIC_LAYERS = 12          # of MusicGen-large's 48: cut in depth to make room for 3s
FRONT_TRAIN_STEPS = 4


def seeded_embeds(shape, seed: int, dev):
    """The stub frontends' patch or frame embeddings: 0.02 x a standard
    normal from a seeded generator on the card (the reference's
    ``make_inputs`` scale)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * 0.02


def paged_vs_full(label: str, params, buffers, cfg, batch, n_steps: int, step_input,
                  dev, card: str):
    """``batch`` (B lanes of patches + text, or of frames) prefilled into a
    pool through ``apply_prefill_paged``, then ``n_steps`` steps of
    ``apply_decode_paged``, step ``t`` fed ``step_input(t, last logits
    row)`` (the greedy token, or a seeded frame).  The counts are set to 0
    just before and read just after: ``flash_prefill`` L, ``elite_decode_paged``
    L x n_steps, ``rope_elite`` L x (1 + n_steps), nothing else.  Every
    logits row taken (the prefill's last and each step's) must agree with
    ``apply_train`` over the whole sequence (cache off) within LOGIT_TOL.
    → (launches, recorder, max |difference|, wall s of prefill + decode)."""
    import numpy as np
    import torch
    from repro_torch.core.cache import PagedKVPool
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    L, bs = cfg.num_layers, 16
    key = "frames" if cfg.frontend == "audio" else "tokens"
    nv = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    B, P = batch[key].shape[0], nv + batch[key].shape[1]
    mb = -(-(P + n_steps) // bs)
    pool = PagedKVPool(cfg, B * mb, bs, device=dev)
    lanes = list(range(B))
    for b in lanes:
        pool.ensure_capacity(b, P + n_steps)
    bt = pool.block_table_array(lanes, mb)
    sm = np.stack([pool.prefill_slot_mapping(b, 0, P, P) for b in lanes])
    rec = Recorder(L)
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            rows = [lm.apply_prefill_paged(params, buffers, cfg, batch, pool.pages,
                                           torch.from_numpy(sm))[:, -1].clone()]
            fed = []
            for t in range(n_steps):
                fed.append(step_input(t, rows[-1]))
                n = P + t + 1
                rows.append(lm.apply_decode_paged(
                    params, buffers, cfg, {key: fed[-1]}, pool.pages,
                    torch.from_numpy(pool.slot_mapping(lanes, [n - 1] * B)), bt,
                    np.full(B, n, np.int32), bs)[:, -1].clone())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launches().items() if v}
    finally:
        rec.close()
    want = {"flash_prefill": L, "elite_decode_paged": L * n_steps,
            "rope_elite": L * (1 + n_steps)}
    print(f"{label} launches: {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    del pool
    full = dict(batch, **{key: torch.cat([batch[key]] + fed, dim=1)})
    with torch.no_grad():
        ref_rows = lm.apply_train(params, buffers, cfg, full)[:, P - 1:]
    got = torch.stack(rows, dim=1)
    d = (got - ref_rows).abs().amax(dim=(0, 2))                 # per position
    print(f"[{card}] {label}: {B} lanes x ({P} prefilled + {n_steps} decode steps) in "
          f"{wall:.3f} s; every logits row against apply_train over all {P + n_steps} "
          f"positions: max |difference| prefill row {float(d[0]):.3e}, decode rows "
          f"{float(d[1:].max()):.3e} (limit {LOGIT_TOL})", flush=True)
    if not float(d.max()) <= LOGIT_TOL:
        raise AssertionError(f"{label}: cache on != cache off, max |difference| "
                             f"{float(d.max())} at row {int(d.argmax())}")
    return launches, rec, float(d.max()), wall


def frontend_training(label: str, params, buffers, cfg, batches, tc, dev, card: str) -> dict:
    """``train_loop.train`` over ``batches`` with the counts set to 0
    before: every step must launch the rotation 2 x L times forward (full
    remat) and L times backward and nothing else; losses finite.  → losses,
    step ms (host clock, the loss read each step), peak memory."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_loop
    L = cfg.num_layers
    per_step = {"rope_elite": 2 * L, "rope_elite_backward": L}
    losses, stamps, seen = [], [], {}

    def cb(step, metrics):
        losses.append(float(metrics["loss"]))          # waits for the step
        stamps.append(time.perf_counter())
        n = ops.launches()
        got = {k: n[k] - seen.get(k, 0) for k in n if n[k] - seen.get(k, 0)}
        seen.update(n)
        if got != per_step:
            raise AssertionError(f"{label} step {step}: launches {got}, expected {per_step}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    stamps.append(time.perf_counter())
    p, _, _ = train_loop.train(params, buffers, cfg, tc, iter(batches), len(batches),
                               log_every=0, callback=cb)
    del p
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = np.diff(stamps) * 1e3
    print(f"[{card}] {label}: losses " + " ".join(f"{v:.4f}" for v in losses)
          + "; step ms " + " ".join(f"{t:.1f}" for t in step_ms)
          + f"; peak memory {peak / 2**30:.2f} GiB; rotation launches per step {per_step}",
          flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    return dict(losses=losses, step_ms=step_ms, peak=peak)


def convert_timed(label: str, params, buffers, cfg, calib, e, dev, card: str):
    """``ropelite.search_model`` (MoE layers captured through the dense
    oracle, its default) and ``convert.convert_model`` on the calibration
    batch (what ``convert.elitekv_from_baseline`` runs), timed apart, with
    the counts set to 0 before: ``rope_elite`` once per attention layer in
    the capture and once in the search, nothing else.  → (converted params,
    buffers, cfg, {"search", "convert" s, "sets"})."""
    import torch
    from repro_torch.core import convert, ropelite
    from repro_torch.kernels import ops
    L = cfg.n_attn_layers
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sets = ropelite.search_model(params, buffers, cfg, calib, e.elite_r)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launches().items() if v}
    if launches != {"rope_elite": 2 * L}:
        raise AssertionError(f"{label} search: launches {launches}, expected "
                             f"{{'rope_elite': {2 * L}}}")
    if list(sets) != list(cfg.attn_layer_indices):
        raise AssertionError(f"{label}: sets for layers {list(sets)}, attention layers "
                             f"{cfg.attn_layer_indices}")
    t0 = time.perf_counter()
    cp, cb, ccfg = convert.convert_model(params, buffers, cfg, sets, e)
    torch.cuda.synchronize()
    t_convert = time.perf_counter() - t0
    shape = {k: tuple(v.shape) for k, v in calib.items()}
    first = next(iter(sets))
    print(f"[{card}] {label}: RoPElite capture + greedy search r={e.elite_r} over {L} "
          f"attention layers {list(sets)} of {cfg.num_layers} on {shape} {t_search:.2f} s "
          f"({t_search / L:.3f} s per attention layer; launches {launches}), J-LRD SVDs "
          f"and surgery d_ckv={e.d_ckv} {t_convert:.2f} s ({t_convert / L:.3f} s per "
          f"attention layer); layer {first}'s elite chunks of kv head 0: "
          f"{sets[first][0].tolist()}", flush=True)
    return cp, cb, ccfg, dict(search=t_search, convert=t_convert, sets=sets)


def frontends(dev, card: str) -> dict:
    """Phase 3m: InternVL2-2B (24 layers) and MusicGen-large (12 of 48 layers) at
    full width, each converted from a seeded baseline at a quarter cache,
    served and trained on the card through the reference's batch inputs
    (``patch_embeds``, ``tokens``, ``frames``), each freed before the next;
    then the kernels at their busiest 3m inputs.  → numbers for the
    summary."""
    from repro_torch.kernels.elite_decode import visited_rows
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.convert import pick_dims
    from repro_torch.launch.serve import build_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import serve_loop, train_loop
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    flush = torch.empty(64 * 2**20 // 4, device=dev).zero_       # > the 50 MB L2
    _free_card()
    out = {"subrows": [], "held": torch.cuda.memory_allocated()}
    print(f"[{card}] 3m: {out['held'] / 2**30:.2f} GiB allocated on the card before the "
          f"first model (earlier phases' recorded inputs and pools)", flush=True)
    weights = lambda p: sum(t.numel() * t.element_size() for t in leaves(p))

    # a. InternVL2-2B: converted, paged prefill with patches, Scheduler, uptraining
    cfg = build_config("internvl2_2b", reduced=False, cache_ratio=0.25, elitekv=False)
    e = pick_dims(cfg, 0.25, align=16)
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.padded_vocab, cfg.n_frontend_tokens, e.elite_r, e.d_ckv) == \
        (24, 2048, 16, 8, 128, 92672, FRONT_PATCHES, 16, 256), (cfg, e)
    L, V = cfg.num_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    print(f"[{card}] 3m a. InternVL2-2B baseline, 24 layers at full width: "
          f"{weights(params) / 1e9:.2f} GB of f32 weights; EliteKV r={e.elite_r} "
          f"d_ckv={e.d_ckv}: {2 * e.elite_r * cfg.n_kv_heads + e.d_ckv} floats per token "
          f"and layer against {2 * cfg.n_kv_heads * cfg.head_dim}", flush=True)
    ids = lambda shape, seed: torch.from_numpy(np.random.default_rng(seed).integers(
        0, V, shape)).to(dev)
    calib = {"patch_embeds": seeded_embeds((4, FRONT_PATCHES, cfg.d_model), 21, dev),
             "tokens": ids((4, FRONT_TEXT), 22)}
    cp, cb, ccfg, a = convert_timed("3m InternVL2-2B conversion", params, buffers, cfg,
                                    calib, e, dev, card)
    del params, buffers, calib
    _free_card()
    batch = {"patch_embeds": seeded_embeds((FRONT_LANES, FRONT_PATCHES, cfg.d_model), 23,
                                           dev),
             "tokens": ids((FRONT_LANES, FRONT_TEXT), 24)}
    launches, rec, a["paged_d"], a["paged_wall"] = paged_vs_full(
        "3m InternVL2-2B paged prefill (patches + text) and greedy decode", cp, cb, ccfg,
        batch, FRONT_DECODE, lambda t, row: row.argmax(-1)[:, None], dev, card)
    busy = max(rec.calls["elite_decode_paged"],
               key=lambda c: visited_rows("elite_decode_paged", c))
    pre = rec.calls["flash_prefill"][0]
    del rec, batch
    # text-only requests through the Scheduler, held to generate row by row
    prompts = np.random.default_rng(25).integers(0, V, (8, FRONT_TEXT)).astype(np.int32)
    reqs = [serve_loop.Request(uid=i, prompt=prompts[i], max_new_tokens=FRONT_DECODE)
            for i in range(8)]
    scfg = serve_loop.SchedulerConfig(max_slots=8, block_size=16, num_blocks=8 * 24,
                                      max_new_tokens=FRONT_DECODE, max_len=1024,
                                      prefill_chunk_tokens=256, prefill_batch_lanes=8)
    rows, undo = {}, []
    try:
        rep, _, _, sched = serve_run(
            "3m InternVL2-2B Scheduler, 8 text requests", cp, cb, ccfg, scfg, reqs, card,
            setup=lambda s: undo.append(record_greedy_rows([s], [rows])))
    finally:
        for u in undo:
            u()
    a["rep"] = rep
    a["cmp"] = compare_greedy_rows("3m InternVL2-2B Scheduler vs generate", sched, rows,
                                   cp, cb, ccfg, dev, card)
    del rows, sched
    # uptraining on batches with patch embeddings
    batches = []
    for s in range(FRONT_TRAIN_STEPS):
        toks = ids((2, FRONT_TEXT + 1), 30 + s)
        batches.append({"patch_embeds": seeded_embeds((2, FRONT_PATCHES, cfg.d_model),
                                                      40 + s, dev),
                        "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    a["train"] = frontend_training(
        f"3m InternVL2-2B uptraining, {FRONT_TRAIN_STEPS} AdamW steps (f32 moments, lr "
        f"{TRAIN_LR}) at B 2 x ({FRONT_PATCHES} patches + {FRONT_TEXT} tokens)", cp, cb, ccfg,
        batches, train_loop.TrainConfig(lr=TRAIN_LR), dev, card)
    del batches
    # card vs CPU gradients of the converted model's first 2 layers
    toks = torch.from_numpy(np.random.default_rng(26).integers(0, V, (2, 129)))
    grads_card_vs_cpu(
        "3m InternVL2-2B, 2 of 24 layers", {**cp, "layers": cp["layers"][:2]},
        {"layers": cb["layers"][:2]}, dataclasses.replace(ccfg, num_layers=2),
        {"patch_embeds": seeded_embeds((2, 128, cfg.d_model), 27, dev).cpu(),
         "tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev, card)
    a["launches"] = launches
    a["peak"] = torch.cuda.max_memory_allocated()
    del cp, cb
    _free_card()
    out["subrows"] += [
        kernel_subrow("InternVL2-2B busiest paged decode", "elite_decode_paged", busy,
                      launches["elite_decode_paged"], card, flush, phase="3m"),
        kernel_subrow("InternVL2-2B paged prefill (256 patches + 256 tokens)",
                      "flash_prefill", pre, launches["flash_prefill"], card, flush,
                      phase="3m")]
    del busy, pre
    out["internvl"] = a

    # b. MusicGen-large: frames in, an lm_head out, no embedding table
    cfg = build_config("musicgen_large", reduced=False, cache_ratio=0.25, elitekv=False)
    e = pick_dims(cfg, 0.25, align=16)
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.padded_vocab, e.elite_r, e.d_ckv) == (48, 2048, 32, 32, 64, 2048, 8, 512), \
        (cfg, e)
    cfg = dataclasses.replace(cfg, num_layers=MUSIC_LAYERS)
    L, V = cfg.num_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    assert "embed" not in params and "lm_head" in params
    print(f"[{card}] 3m b. MusicGen-large baseline, {L} of 48 layers at full width: "
          f"{weights(params) / 1e9:.2f} GB of f32 weights, no embedding table; EliteKV "
          f"r={e.elite_r} d_ckv={e.d_ckv}: {2 * e.elite_r * cfg.n_kv_heads + e.d_ckv} floats "
          f"per token and layer against {2 * cfg.n_kv_heads * cfg.head_dim}", flush=True)
    cp, cb, ccfg, b = convert_timed(
        "3m MusicGen-large conversion", params, buffers, cfg,
        {"frames": seeded_embeds((2, MUSIC_FRAMES, cfg.d_model), 51, dev)}, e, dev, card)
    del params, buffers
    _free_card()
    frames = seeded_embeds((MUSIC_LANES, MUSIC_FRAMES + MUSIC_DECODE, cfg.d_model), 52, dev)
    launches, rec, b["paged_d"], b["paged_wall"] = paged_vs_full(
        "3m MusicGen-large paged prefill (frames) and decode of seeded frames", cp, cb, ccfg,
        {"frames": frames[:, :MUSIC_FRAMES]}, MUSIC_DECODE,
        lambda t, row: frames[:, MUSIC_FRAMES + t:MUSIC_FRAMES + t + 1], dev, card)
    busy = max(rec.calls["elite_decode_paged"],
               key=lambda c: visited_rows("elite_decode_paged", c))
    pre = rec.calls["flash_prefill"][0]
    del rec, frames
    # one training step on frames and labels; int8 moments: the functional
    # AdamW holds old and new weights and moments at once, which with f32
    # moments would be ~96 GB for 3.0 B parameters
    step = {"frames": seeded_embeds((2, MUSIC_FRAMES, cfg.d_model), 53, dev),
            "labels": ids((2, MUSIC_FRAMES), 54)}
    b["train"] = frontend_training(
        f"3m MusicGen-large, one AdamW step (int8 moments, lr {TRAIN_LR}) at B 2 x "
        f"{MUSIC_FRAMES} frames", cp, cb, ccfg, [step],
        train_loop.TrainConfig(lr=TRAIN_LR, optimizer=AdamWConfig(moment_dtype="int8")),
        dev, card)
    b["launches"] = launches
    b["peak"] = torch.cuda.max_memory_allocated()
    del cp, cb, step
    _free_card()
    out["subrows"] += [
        kernel_subrow("MusicGen-large busiest paged decode", "elite_decode_paged", busy,
                      launches["elite_decode_paged"], card, flush, phase="3m"),
        kernel_subrow("MusicGen-large paged prefill (512 frames)", "flash_prefill", pre,
                      launches["flash_prefill"], card, flush, phase="3m")]
    del busy, pre
    out["musicgen"] = b
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3m (frontends) {out['wall']:.1f} s", flush=True)
    return out


# -- training and conversion of MoE, Mamba and hybrid stacks (phase 3n) -----------

CALIB_3N = (4, 512)          # calibration tokens of the 3n conversions
MOE_TRAIN_S = 512            # Qwen3-MoE and Jamba loss and backward at B 1 x S 512
JAMBA_TRAIN_LAYERS = 4       # Jamba's layers 0-3 (attention at 3): the backward's cut
# 2 steps (4 until phase 3s took their time; depth only)
FALCON_TRAIN_LAYERS, FALCON_B, FALCON_STEPS = 8, 8, 2
STEP_RTOL = 1e-5             # card vs CPU params after one step, of a leaf's largest
BIG_GRAD = 1e-4              # a first Adam step moves a weight of |g| >= this by ±lr
# a stack with Mamba layers decodes by the one-token recurrence where the
# cache-off forward runs the chunked scan: its rows are held to the
# reference's own tolerance for the recurrence against the scan
# (tests/test_moe_mamba.py::test_mamba_naive_recurrence_oracle), |Δ| <=
# atol + rtol·|want|; attention-only stacks to LOGIT_TOL
RECURRENCE_TOL = (2e-4, 2e-4)
AVAILABLE_GIB = 79.2         # what an H100 80GB gives torch (its total_memory)


def first_rotation(calls: list):
    """Replace ``ops.rope_elite_qk`` with a wrapper that keeps the first
    call's arguments in ``calls``.  → undo."""
    from repro_torch.kernels import ops
    rotate = ops.rope_elite_qk

    def keep(*a):
        if not calls:
            calls.append(a)
        return rotate(*a)
    ops.rope_elite_qk = keep
    return lambda: setattr(ops, "rope_elite_qk", rotate)


def backward_args(fwd, head_dim: int, dev, seed: int):
    """The rotation's backward inputs at a recorded forward call's shapes
    and strides (as phase 3k builds row 9d's): q's gradient the slice
    [..., :2r] of a [B, S, nh, dh] gradient of [q_e | q_ne], k's a
    contiguous [B, S, nkv, 2r]; positions, freqs and groups the call's."""
    import torch
    q, k, pos, freqs, qpr, kpr = fwd
    g = torch.Generator(device=dev).manual_seed(seed)
    gq = torch.randn(q.shape[:3] + (head_dim,), generator=g, device=dev)[..., :q.shape[-1]]
    return gq, torch.randn(tuple(k.shape), generator=g, device=dev), pos, freqs, qpr, kpr


def loss_backward(label: str, params, buffers, cfg, batch, moe_impl: str, dev, card: str):
    """``lm.loss_fn`` (``moe_impl``) and its backward on the card, the
    counts set to 0 just before: under full remat the rotation must launch
    twice per attention layer forward and once backward, nothing else.
    → dict(grads, loss, fwd_ms, bwd_ms, peak, syncs: group-size reads,
    launches, rotation: the first forward rotation's arguments)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, moe
    from repro_torch.tree import items, map_tree
    p = map_tree(lambda t: t.detach().requires_grad_(True), params)
    names, leaves = zip(*items(p))
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    syncs = moe.group_size_syncs
    undo = first_rotation(calls)
    try:
        t0 = time.perf_counter()
        loss, aux = lm.loss_fn(p, buffers, cfg, batch, moe_impl=moe_impl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        undo()
    out = dict(grads=grads, loss=float(loss.detach()), fwd_ms=(t1 - t0) * 1e3,
               bwd_ms=(t2 - t1) * 1e3, peak=torch.cuda.max_memory_allocated(dev),
               syncs=moe.group_size_syncs - syncs,
               launches={k: v for k, v in ops.launches().items() if v},
               rotation=calls[0] if calls else None)
    L = cfg.n_attn_layers
    want = {"rope_elite": 2 * L, "rope_elite_backward": L} if L else {}
    print(f"[{card}] {label} ({moe_impl}): loss {out['loss']:.6f} (ce "
          f"{float(aux['ce']):.6f}, balance {float(aux['aux']):.6f}); forward "
          f"{out['fwd_ms']:.1f} ms, backward {out['bwd_ms']:.1f} ms; group-size syncs "
          f"{out['syncs']} per step; launches {out['launches']}; peak memory "
          f"{out['peak'] / 2**30:.2f} GiB", flush=True)
    if out["launches"] != want:
        raise AssertionError(f"{label} ({moe_impl}): launches {out['launches']}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError(f"{label} ({moe_impl}): a gradient is not finite")
    return out


def grads_agree(label: str, got: dict, want: dict, least_gap: float, card: str) -> float:
    """Every leaf of ``got`` within ``GRAD_RTOL`` of ``want``'s largest +
    1e-7, unless a router came within ``ROUTE_GAP`` of another expert
    choice (then the leaves past it are counted and excused).  → the worst
    max|Δ| / max|g|."""
    from routing_margins import ROUTE_GAP
    worst, bad = (0.0, ""), []
    for name, w in want.items():
        d = float((got[name] - w).abs().max())
        worst = max(worst, (d / (float(w.abs().max()) + 1e-30), name))
        if d > GRAD_RTOL * float(w.abs().max()) + 1e-7:
            bad.append(name)
    print(f"[{card}] {label}, {len(want)} leaves: worst max|Δ| / max|g| {worst[0]:.3e} "
          f"({worst[1]}), tolerance {GRAD_RTOL}; least router gap {least_gap:.3e}"
          + (f"; {len(bad)} leaves past it, excused by routing" if bad else ""), flush=True)
    if bad and not least_gap < ROUTE_GAP:
        raise AssertionError(f"{label}: {bad[:4]} past {GRAD_RTOL} of their largest")
    return worst[0]


def generate_held_to_train(label: str, params, buffers, cfg, prompts, n_new: int, want,
                           card: str) -> dict:
    """``generate_run`` keeping every lane's logits row of every forward;
    then each row against ``apply_train`` over the prompt and the generated
    tokens (cache on == cache off) within LOGIT_TOL, or RECURRENCE_TOL for
    a stack with Mamba layers.  A row past it is excused only where the
    reference forward's router came within ROUTE_GAP of another expert on
    that row's context.  → numbers."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from routing_margins import ROUTE_GAP, recorded_gaps
    rows, real_p, real_d = [], lm.apply_prefill, lm.apply_decode

    def keep(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            rows.append(out[:, -1].clone())
            return out
        return run

    lm.apply_prefill, lm.apply_decode = keep(real_p), keep(real_d)
    try:
        out, stats, wall, rec, launches = generate_run(label, params, buffers, cfg, prompts,
                                                       n_new, want, card)
    finally:
        lm.apply_prefill, lm.apply_decode = real_p, real_d
    del rec                                  # its recorded calls hold the cache
    dev = lm.params_device(params)
    B, P = prompts.shape
    toks = torch.from_numpy(np.concatenate([prompts, out[:, :-1]], axis=1)).to(dev)
    with torch.no_grad(), recorded_gaps([]) as calls:
        full = lm.apply_train(params, buffers, cfg, toks)[:, P - 1:]
    got = torch.stack(rows, dim=1)                               # [B, n_new, Vp]
    diff = (got - full).abs()
    d = diff.amax(-1).cpu().numpy()                              # [B, n_new]
    atol, rtol = RECURRENCE_TOL if cfg.ssm_state else (LOGIT_TOL, 0.0)
    over = (diff > atol + rtol * full.abs()).any(-1).cpu().numpy()
    scale = float(full[..., :cfg.vocab_size].abs().max())       # not the -1e30 padding
    del full, got, rows, diff
    if calls:     # least gap over each row's context, per lane and position
        gap = torch.stack([c.reshape(B, -1).cpu() for c in calls]).amin(0)
        gap = torch.cummin(gap, dim=1).values[:, P - 1:].numpy()
    else:
        gap = np.full(d.shape, np.inf)
    past = over
    excused = past & (gap < ROUTE_GAP)
    r = dict(stats=stats, wall=wall, launches=launches, max_d=float(d[~past].max(initial=0)),
             bitwise=int((d == 0).sum()), rows=d.size, excused=int(excused.sum()),
             least_gap=float(gap.min()), over_1e4=int((d > LOGIT_TOL).sum()))
    print(f"[{card}] {label}: {d.size} logits rows ({B} lanes x {n_new}) against "
          f"apply_train over prompt + generated tokens: max |difference| {r['max_d']:.3e} "
          f"(limit {atol} + {rtol}·|want|; |want| up to {scale:.3f}), p50/p99 "
          f"{np.percentile(d, 50):.3e}/{np.percentile(d, 99):.3e}, {r['over_1e4']} rows past "
          f"{LOGIT_TOL} absolute, bitwise equal {r['bitwise']}, {r['excused']} excused by a "
          f"router gap under {ROUTE_GAP:.0e} (least gap {r['least_gap']:.3e})", flush=True)
    if (past & ~excused).any():
        b, t = map(int, np.argwhere(past & ~excused)[0])
        raise AssertionError(f"{label}: lane {b} row {t} differs by {d[b, t]:.3e}, router "
                             f"gap {gap[b, t]:.3e}")
    return r


def step_card_vs_cpu(label: str, arch: str, dev, card: str) -> dict:
    """Part e: one whole ``make_train_step`` (int8 moments, ragged MoE) of
    a reduced EliteKV model on the card against the same step on the CPU
    (plain versions), by the CPU tests' rule for one step
    (``tests/test_torch_train.py``): a first Adam step moves a weight by
    about lr times its gradient's sign, so a weight whose CPU gradient is
    at least ``BIG_GRAD`` is held to ``STEP_RTOL`` of its leaf's largest,
    and any other, whose gradient is near the optimizer's eps or zero and
    whose sign rounding may flip, within 2·lr (counted).  The card's step must launch the rotation twice per attention
    layer forward and once backward."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train_loop
    from repro_torch.tree import items, map_tree
    from routing_margins import ROUTE_GAP, recorded_gaps
    cfg = build_config(arch, reduced=True, cache_ratio=0.25)
    params, buffers = lm.init(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(73).integers(0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = train_loop.TrainConfig(lr=TRAIN_LR, optimizer=AdamWConfig(moment_dtype="int8"),
                                moe_impl="ragged")
    step = train_loop.make_train_step(cfg, tc)
    with recorded_gaps([]) as calls:
        p = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = lm.loss_fn(p, buffers, cfg, batch, moe_impl="ragged")
        names, leaves = zip(*items(p))
        grad = dict(zip(names, torch.autograd.grad(loss, leaves)))
    least = min((float(c.min()) for c in calls), default=float("inf"))
    want, _, wm = step(params, buffers, train_loop.init_opt_state(params, tc), batch)
    cp, cb = map_tree(lambda t: t.to(dev), params), map_tree(lambda t: t.to(dev), buffers)
    ops.reset_launches()
    got, _, gm = step(cp, cb, train_loop.init_opt_state(cp, tc),
                      {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if v}
    L = cfg.n_attn_layers
    if launches != {"rope_elite": 2 * L, "rope_elite_backward": L}:
        raise AssertionError(f"{label}: launches {launches}")
    want, got = dict(items(want)), {k: v.cpu() for k, v in items(got)}
    worst, flips, bad = (0.0, ""), 0, []
    for name, w in want.items():
        d = (got[name] - w).abs()
        flip = grad[name].abs() < BIG_GRAD
        held = float(d[~flip].max()) if bool((~flip).any()) else 0.0
        scale = float(w.abs().max())
        worst = max(worst, (held / scale, name))
        flips += int((flip & (d > STEP_RTOL * scale)).sum())
        if held > STEP_RTOL * scale or float(d.max()) > 2 * TRAIN_LR + STEP_RTOL * scale:
            bad.append(name)
    print(f"[{card}] {label}, reduced {cfg.name} ({cfg.num_layers} layers, {L} attention): "
          f"one AdamW step (int8 moments, lr {TRAIN_LR}, ragged MoE), card vs CPU over "
          f"{len(want)} leaves: loss {float(gm['loss']):.6f} vs {float(wm['loss']):.6f}, "
          f"worst max|Δ| / max|p| {worst[0]:.3e} ({worst[1]}) against {STEP_RTOL} where |g| >= "
          f"{BIG_GRAD}; {flips} weights of smaller gradient past it, all within 2·lr; launches "
          f"{launches}; "
          f"least router gap {least:.3e}", flush=True)
    if bad and not least < ROUTE_GAP:
        raise AssertionError(f"{label}: {bad[:4]} past {STEP_RTOL} of their largest")
    return dict(worst=worst[0], flips=flips)


def rotation_backward_subrow(label: str, a, launches: int, card: str, flush) -> dict:
    """Row 9d's kernel (the rotation's transpose mode) at recorded training
    inputs ``a``: held to its plain version, then timed against its bound
    as phase 4 times row 9d."""
    from repro_torch.kernels.rope_elite import rope_cost
    from repro_torch.kernels import ref
    from repro_torch.kernels import rope_elite as re_k
    e, bad, same = rope_err(re_k.rope_elite_backward(*a),
                            ref.rope_elite_qk_ref(*a, transpose=True))
    if bad:
        raise AssertionError(f"rope_elite_backward at {label}: {bad} elements past the "
                             "tolerance")
    nbytes, flops = rope_cost(a)
    t_bound, by = bound(nbytes, flops)
    r = dict(name="rope_elite_backward", at=label, launches=launches, max_abs_err=e,
             ms=time_ms(lambda: re_k.rope_elite_backward(*a), flush=flush),
             plain_ms=time_ms(lambda: ref.rope_elite_qk_ref(*a, transpose=True),
                              flush=flush),
             bound_ms=t_bound, bound_by=by, library_ms=None)
    print(f"[{card}] 3n kernel rope_elite_backward at {label} (g_q {tuple(a[0].shape)} "
          f"stride {a[0].stride()}, g_k {tuple(a[1].shape)}, {re_k.plan_for(*a)}): "
          f"max_abs_err {e:.3e}, bitwise equal {100 * same:.2f}%; {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {t_bound:.6f} ms ({by}: {nbytes} B, {flops} flop), "
          f"{100 * t_bound / r['ms']:.1f}% of the bound; launches {launches}", flush=True)
    return r


def moe_mamba_training(dev, card: str) -> dict:
    """Phase 3n: training and conversion of MoE, Mamba and hybrid stacks at
    full width (a-d), card against CPU steps at reduced widths (e), and
    the rotation's backward at the new training shapes (f).  → numbers for
    the summary."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.convert import pick_dims
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_config
    from repro_torch.models import lm
    from repro_torch.runtime import train_loop
    from repro_torch.tree import leaves
    from routing_margins import recorded_gaps
    t_phase = time.perf_counter()
    flush = torch.empty(64 * 2**20 // 4, device=dev).zero_       # > the 50 MB L2
    _free_card()
    out = {"subrows": [], "held": torch.cuda.memory_allocated()}
    print(f"[{card}] 3n: {out['held'] / 2**30:.2f} GiB allocated on the card before the "
          f"first model (earlier phases' recorded inputs and pools)", flush=True)
    weights = lambda p: sum(t.numel() * t.element_size() for t in leaves(p))
    ids = lambda shape, seed, V: torch.from_numpy(np.random.default_rng(seed).integers(
        0, V, shape)).to(dev)

    # a. Qwen3-MoE-235B, 1 of 94 layers: converted, then loss and backward
    # through ragged and dense
    t0 = time.perf_counter()
    cfg = dataclasses.replace(build_config("qwen3_moe_235b", reduced=False, cache_ratio=0.25,
                                           elitekv=False), num_layers=1)
    e = pick_dims(cfg, 0.25, align=16)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts,
            e.elite_r, e.d_ckv) == (4096, 64, 4, 128, 128, 16, 128), (cfg, e)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    print(f"[{card}] 3n a. Qwen3-MoE-235B baseline, 1 of 94 layers at full width: "
          f"{weights(params) / 1e9:.2f} GB of f32 weights", flush=True)
    cp, cb, ccfg, a = convert_timed("3n a. Qwen3-MoE 1 layer conversion (MoE dense)", params,
                                    buffers, cfg, {"tokens": ids(CALIB_3N, 70, V)}, e, dev, card)
    del params, buffers
    _free_card()
    toks = ids((1, MOE_TRAIN_S + 1), 71, V)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # a first pass pays one-time costs (8-13 s for a fresh process; PERF.md §6)
    a["first"] = loss_backward("3n a. Qwen3-MoE 1 layer, B 1 x 512, first pass", cp, cb,
                               ccfg, batch, "ragged", dev, card)
    del a["first"]["grads"], a["first"]["rotation"]
    with recorded_gaps([]) as calls:
        a["ragged"] = loss_backward("3n a. Qwen3-MoE 1 layer, B 1 x 512", cp, cb, ccfg, batch,
                                    "ragged", dev, card)
    least = min(float(c.min()) for c in calls)
    del calls
    a["dense"] = loss_backward("3n a. Qwen3-MoE 1 layer, B 1 x 512", cp, cb, ccfg, batch,
                               "dense", dev, card)
    a["worst"] = grads_agree("3n a. Qwen3-MoE gradients, ragged against dense",
                             a["ragged"]["grads"], a["dense"]["grads"], least, card)
    if a["ragged"]["syncs"] != 2 * ccfg.num_layers or a["dense"]["syncs"]:
        raise AssertionError(f"group-size syncs {a['ragged']['syncs']} ragged, "
                             f"{a['dense']['syncs']} dense")
    n = sum(t.numel() for t in leaves(cp))
    head = cp["lm_head"]["w"].numel()
    a["adamw_gb"] = {"f32": 34 * n / 1e9, "int8": 20 * n / 1e9, "lm_head": 4 * 4 * head / 1e9}
    print(f"[{card}] 3n a. why the whole AdamW step of this layer does not fit: {n / 1e9:.3f} "
          f"B parameters; the functional update holds old and new weights, the gradients and "
          f"their clipped copy, old and new moments: ~34 B per parameter with f32 moments "
          f"({a['adamw_gb']['f32']:.1f} GB), ~20 B with int8 ({a['adamw_gb']['int8']:.1f} GB), "
          f"plus ~{a['adamw_gb']['lm_head']:.1f} GB of f32 update transients of the 2-D "
          f"lm_head leaf [{cfg.d_model}, {cfg.padded_vocab}] (update_chunk cuts only leaves of "
          f"3+ axes), against the card's {AVAILABLE_GIB} GiB; the loss and its backward above "
          f"hold weights and gradients ({2 * 4 * n / 1e9:.1f} GB)", flush=True)
    qwen_rot = backward_args(a["ragged"]["rotation"], cfg.head_dim, dev, 74)
    qwen_launches = a["ragged"]["launches"]["rope_elite_backward"]
    for k in ("ragged", "dense"):
        del a[k]["grads"], a[k]["rotation"]
    del cp, cb, batch, toks
    _free_card()
    a["wall"] = time.perf_counter() - t0
    out["qwen1"] = a

    # b. Qwen3-MoE-235B, QWEN_LAYERS of 94 layers, converted from a baseline and
    # served through generate, rows held to apply_train
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=QWEN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    print(f"[{card}] 3n b. Qwen3-MoE-235B baseline, {QWEN_LAYERS} of 94 layers: "
          f"{weights(params) / 1e9:.2f} GB of f32 weights", flush=True)
    cp, cb, ccfg, b = convert_timed(f"3n b. Qwen3-MoE {QWEN_LAYERS} layers conversion", params,
                                    buffers, cfg, {"tokens": ids(CALIB_3N, 75, V)}, e, dev, card)
    del params, buffers
    _free_card()
    L, N = ccfg.num_layers, 32
    prompts = np.random.default_rng(76).integers(0, V, (8, 512))
    b["gen"] = generate_held_to_train(
        f"3n b. generate converted Qwen3-MoE {L} layers 8 x (512 + {N})", cp, cb, ccfg,
        prompts, N, {"elite_decode": L * (N - 1), "flash_prefill": L, "rope_elite": L * N},
        card)
    b["peak"] = torch.cuda.max_memory_allocated()
    del cp, cb
    _free_card()
    b["wall"] = time.perf_counter() - t0
    out["qwen4"] = b

    # c. Jamba-v0.1, one period, converted (search over its attention layer
    # 3, J-LRD there) and served through generate; then its layers 0-3
    # (attention at 3, two MoE FFNs) through the loss and its backward
    t0 = time.perf_counter()
    cfg = dataclasses.replace(build_config("jamba_v0_1_52b", reduced=False, cache_ratio=0.25,
                                           elitekv=False), num_layers=JAMBA_LAYERS)
    e = pick_dims(cfg, 0.25, align=16)
    assert (cfg.attn_layer_indices, cfg.n_heads, cfg.n_kv_heads, e.elite_r, e.d_ckv) == \
        ((3,), 32, 8, 16, 256), (cfg, e)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params, buffers = lm.init(cfg, seed=0, device=dev)
    print(f"[{card}] 3n c. Jamba-v0.1 baseline, one period ({JAMBA_LAYERS} of 32 layers): "
          f"{weights(params) / 1e9:.2f} GB of f32 weights", flush=True)
    cp, cb, ccfg, c = convert_timed("3n c. Jamba period conversion (MoE dense)", params,
                                    buffers, cfg, {"tokens": ids(CALIB_3N, 77, V)}, e, dev, card)
    if not all(cp["layers"][i]["attn"] is params["layers"][i]["attn"]
               for i in range(JAMBA_LAYERS) if cfg.layer_kind(i) == "ssm"):
        raise AssertionError("Jamba: a Mamba layer was not passed through the conversion")
    del params, buffers
    _free_card()
    N = 128
    prompts = np.random.default_rng(78).integers(0, V, (8, 1024))
    c["gen"] = generate_held_to_train(
        f"3n c. generate converted Jamba period 8 x (1024 + {N})", cp, cb, ccfg, prompts, N,
        {"elite_decode": N - 1, "flash_prefill": 1, "rope_elite": N}, card)
    c["peak"] = torch.cuda.max_memory_allocated()
    half = {**cp, "layers": cp["layers"][:JAMBA_TRAIN_LAYERS]}
    hb = {"layers": cb["layers"][:JAMBA_TRAIN_LAYERS]}
    del cp, cb
    _free_card()
    hcfg = dataclasses.replace(ccfg, num_layers=JAMBA_TRAIN_LAYERS)
    toks = ids((1, MOE_TRAIN_S + 1), 79, V)
    c["first"] = loss_backward(f"3n c. converted Jamba layers 0-{JAMBA_TRAIN_LAYERS - 1}, "
                               f"B 1 x 512, first pass", half, hb, hcfg,
                               {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, "ragged",
                               dev, card)
    del c["first"]["grads"], c["first"]["rotation"]
    c["train"] = loss_backward(f"3n c. converted Jamba layers 0-{JAMBA_TRAIN_LAYERS - 1} "
                               f"({weights(half) / 1e9:.2f} GB), B 1 x 512", half, hb, hcfg,
                               {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, "ragged",
                               dev, card)
    jamba_rot = backward_args(c["train"]["rotation"], cfg.head_dim, dev, 80)
    jamba_launches = c["train"]["launches"]["rope_elite_backward"]
    del c["train"]["grads"], c["train"]["rotation"], half, hb, toks
    _free_card()
    c["wall"] = time.perf_counter() - t0
    out["jamba"] = c

    # d. Falcon-Mamba-7B, 8 of 64 layers: AdamW steps (f32 moments), then
    # one layer's loss and backward with and without the per-chunk recompute
    t0 = time.perf_counter()
    cfg = dataclasses.replace(build_config("falcon_mamba_7b", reduced=False, cache_ratio=0.25),
                              num_layers=FALCON_TRAIN_LAYERS)
    assert (cfg.d_inner, cfg.ssm_state, cfg.ssm_chunk, cfg.n_attn_layers) == \
        (8192, 16, 128, 0), cfg
    params, buffers = lm.init(cfg, seed=0, device=dev)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_S,
                                    batch_size=FALCON_B, seed=81), device=dev)
    batches = [next(pipe) for _ in range(FALCON_STEPS)]
    losses, stamps = [], []

    def cb(step, metrics):
        losses.append(float(metrics["loss"]))          # waits for the step
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    stamps.append(time.perf_counter())
    p, _, _ = train_loop.train(params, buffers, cfg, train_loop.TrainConfig(lr=TRAIN_LR),
                               iter(batches), FALCON_STEPS, log_every=0, callback=cb)
    del p
    step_ms = np.diff(stamps) * 1e3
    d = dict(losses=losses, step_ms=step_ms, p50=float(np.percentile(step_ms[1:], 50)),
             peak=torch.cuda.max_memory_allocated(dev), params=weights(params) / 4)
    d["tok_s"] = FALCON_B * MOE_TRAIN_S / (d["p50"] / 1e3)
    launches = {k: v for k, v in ops.launches().items() if v}
    print(f"[{card}] 3n d. Falcon-Mamba-7B {FALCON_TRAIN_LAYERS} of 64 layers "
          f"({d['params'] / 1e9:.3f} B parameters), {FALCON_STEPS} AdamW steps (f32 moments, "
          f"lr {TRAIN_LR}) at B {FALCON_B} x S {MOE_TRAIN_S}, scan recomputed per chunk: losses "
          + " ".join(f"{v:.4f}" for v in losses) + "; step ms "
          + " ".join(f"{t:.1f}" for t in step_ms) + f"; p50 {d['p50']:.1f} ms, "
          f"{d['tok_s']:.0f} tokens/s, peak memory {d['peak'] / 2**30:.2f} GiB; launches "
          f"{launches} (no attention layer: no kernel)", flush=True)
    if launches or not np.isfinite(losses).all():
        raise AssertionError(f"Falcon-Mamba training: launches {launches}, losses {losses}")
    del batches, pipe
    one = {**params, "layers": params["layers"][:1]}
    del params
    _free_card()
    toks = ids((FALCON_B, MOE_TRAIN_S + 1), 82, cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for unroll in (False, True):
        base = torch.cuda.memory_allocated(dev)
        c1 = dataclasses.replace(cfg, num_layers=1, ssm_unroll=unroll)
        runs[unroll] = loss_backward(f"3n d. Falcon-Mamba 1 layer, B {FALCON_B} x "
                                     f"{MOE_TRAIN_S}, ssm_unroll={unroll}", one,
                                     {"layers": [{}]}, c1, batch, "ragged", dev, card)
        runs[unroll]["above"] = runs[unroll]["peak"] - base
    # the embedding table's gradient is an accumulating index_put, whose
    # order of additions may change from run to run whatever the scan does:
    # it is held to 1e-6 of its largest, every other leaf bit for bit
    g0, g1 = runs[False]["grads"], runs[True]["grads"]
    same = all(torch.equal(g, g1[k]) for k, g in g0.items() if k != "embed/table")
    emb = float((g0["embed/table"] - g1["embed/table"]).abs().max())
    same = same and emb <= 1e-6 * float(g1["embed/table"].abs().max())
    d["recompute_peak"], d["unroll_peak"] = runs[False]["above"], runs[True]["above"]
    d["recompute_ms"], d["unroll_ms"] = (runs[False]["fwd_ms"] + runs[False]["bwd_ms"],
                                         runs[True]["fwd_ms"] + runs[True]["bwd_ms"])
    print(f"[{card}] 3n d. Falcon-Mamba one layer's loss and backward at B {FALCON_B} x "
          f"{MOE_TRAIN_S}: peak above what was allocated before, per-chunk recompute "
          f"{d['recompute_peak'] / 2**30:.2f} GiB against {d['unroll_peak'] / 2**30:.2f} GiB "
          f"unrolled; forward + backward {d['recompute_ms']:.1f} against "
          f"{d['unroll_ms']:.1f} ms; gradients of every leaf but the embedding table "
          f"bitwise equal, the table's within {emb:.3e}: {same}", flush=True)
    if not same:
        raise AssertionError("Falcon-Mamba: per-chunk recompute changed the gradients")
    del runs, one, batch, toks
    _free_card()
    d["wall"] = time.perf_counter() - t0
    out["falcon"] = d

    # e. card against CPU: one whole train step at reduced widths
    t0 = time.perf_counter()
    out["steps"] = {arch: step_card_vs_cpu(f"3n e. {arch}", arch, dev, card)
                    for arch in ("qwen3_moe_235b", "jamba_v0_1_52b")}
    out["steps_wall"] = time.perf_counter() - t0

    # f. the rotation's backward at the Qwen3-MoE and Jamba training inputs
    out["subrows"] = [
        rotation_backward_subrow("Qwen3-MoE training (64/4 heads, 2r 32 of 128), B 1 x 512",
                                 qwen_rot, qwen_launches, card, flush),
        rotation_backward_subrow("Jamba training (32/8 heads, 2r 32 of 128), B 1 x 512",
                                 jamba_rot, jamba_launches, card, flush)]
    del qwen_rot, jamba_rot, flush
    _free_card()
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 3n (MoE, Mamba and hybrid training and conversion) "
          f"{out['wall']:.1f} s", flush=True)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# -- the dry run against the card (phase 3o) --------------------------------------

# |predicted - measured| peak allowed: the larger of 3% of the measured and 256 MiB
PEAK_REL, PEAK_FLOOR = 0.03, 256 * 2**20
#: the share of the card's memory C2's predicted peak (with what is held) may take
PREFILL_FILL = 0.90
# lists the cells given as a JSON list of [arch, shape] at 16 x 16, one JSON
# line each (run without the card: meta tensors only); the sharded traces
# extrapolated from three and four layer periods
LISTING = """
import json, sys, time
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
        t0 = time.perf_counter()
        r = dryrun.lower_cell(arch, shape, depth="periods")
        if not r["skipped"]:
            m = r["memory"]
            print(json.dumps(dict(arch=arch, shape=shape, resident=m["argument_bytes"],
                                  peak=m["peak_estimate_bytes"], flops=r["flops_per_device"],
                                  even=r["flops_split"] is not None,
                                  colls=r["collective_bytes_per_device"],
                                  s=time.perf_counter() - t0)), flush=True)
"""


def listing_groups():
    """The reference's --all cells (LLaMA2-13B aside) cut into four lists
    for four listing processes side by side: Falcon-Mamba's train cell, its
    other cells, Jamba's, and the rest, so that the slowest (the Mamba scan
    on meta tensors) set the wall time."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    cells = [(a, s) for a in ARCH_IDS if not a.startswith("llama2_13b") for s in SHAPES]
    slow = [[("falcon_mamba_7b", "train_4k")],
            [c for c in cells if c[0] == "falcon_mamba_7b" and c[1] != "train_4k"],
            [c for c in cells if c[0] == "jamba_v0_1_52b"]]
    taken = {c for g in slow for c in g}
    return slow + [[c for c in cells if c not in taken]]


def dryrun_cell_on_card(label: str, arch: str, shape: str, kw: dict, want: dict, dev,
                        card: str) -> dict:
    """Predict one cell on a 1 x 1 plan, then run the same step on the card
    (the launch counts set to 0 just before it) and hold the measured peak
    to the prediction.  ``want``: the launches the step must make."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun
    from repro_torch.tree import leaves
    _free_card()
    build.free_scratch(dev)
    held = torch.cuda.memory_allocated(dev)
    t_cell = t0 = time.perf_counter()
    rec, cell = dryrun.lower_cell(arch, shape, mesh_axes={"data": 1, "model": 1},
                                  return_cell=True, **kw)
    t_pred = time.perf_counter() - t0
    mem = rec["memory"]
    state = dryrun.cell_state(cell, dev, seed=5)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t1 = time.perf_counter()
    out = dryrun.run_step(cell, state)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t1
    launches = {k: v for k, v in ops.launches().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    outs = [t for t in leaves(list(out) if isinstance(out, tuple) else [out])
            if torch.is_tensor(t) and t.is_floating_point()]
    # in pieces of 2**28 elements: a whole-tensor test of C2's logits would
    # need 16 GB more
    finite = all(bool(torch.isfinite(part).all()) for t in outs
                 for part in t.reshape(-1).split(2**28))
    del out, state, outs
    _free_card()
    build.free_scratch(dev)
    measured = peak - held
    pred = mem["peak_estimate_bytes"]
    diff, allowed = abs(pred - measured), max(PEAK_REL * measured, PEAK_FLOOR)
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    print(f"[{card}] 3o {label} {arch} {shape} B {cell.shape.global_batch} x "
          f"{cell.shape.seq_len} ({rec['step']}) on 1x1: predicted peak {pred / 2**30:.3f} GiB "
          f"(resident {mem['argument_bytes'] / 2**30:.3f}, temp {mem['temp_bytes'] / 2**30:.3f} "
          f"at {mem['peak_op']}), {rec['flops_per_device']:.4e} FLOPs, meta trace "
          f"{t_pred:.1f} s; measured max_memory_allocated {peak / 2**30:.3f} GiB with "
          f"{held / 2**30:.3f} GiB held before the cell: {measured / 2**30:.3f} GiB, "
          f"|predicted - measured| {diff / 2**20:.1f} MiB ({100 * diff / measured:.2f}%) against "
          f"{allowed / 2**20:.1f} MiB allowed; step {step_s:.2f} s (cell "
          f"{time.perf_counter() - t_cell:.1f} s); launches {launches}", flush=True)
    for t in rec["largest_at_peak"][:4]:
        print(f"[{card}] 3o {label}   at the peak: {t['bytes'] / 2**30:.3f} GiB "
              f"{t['dtype']}{t['shape']} <- {t['op']}", flush=True)
    if launches != want or launches != calls:
        raise AssertionError(f"3o {label}: launches {launches}, expected {want} (the trace's "
                             f"meta calls {calls})")
    if not finite:
        raise AssertionError(f"3o {label}: an output is not finite")
    if diff > allowed:
        raise AssertionError(f"3o {label}: predicted peak {pred} B against {measured} B "
                             f"measured, {diff} B apart (> {allowed:.0f} B)")
    return dict(label=label, arch=arch, shape=shape, batch=cell.shape.global_batch,
                seq=cell.shape.seq_len, predicted=pred, measured=measured, held=held,
                raw_peak=peak, temp=mem["temp_bytes"], resident=mem["argument_bytes"],
                flops=rec["flops_per_device"], step_s=step_s, diff=diff)


def largest_prefill_batch(room: float, most: int = 32) -> int:
    """The largest batch of at most ``most`` whose predicted ``prefill_32k``
    peak (TinyLlama-1.1B, 1 x 1) is at most ``room`` bytes.  The peak is
    linear in the batch (weights, then per lane its cache, activations and
    logits), so two predictions place it and one or two more confirm it."""
    from repro_torch.launch import dryrun
    peak = lambda b: dryrun.lower_cell("tinyllama_1_1b", "prefill_32k", batch=b, mesh_axes={
        "data": 1, "model": 1})["memory"]["peak_estimate_bytes"]
    p1, p2 = peak(1), peak(2)
    B = max(1, min(most, 1 + int((room - p1) // (p2 - p1))))
    while B > 1 and peak(B) > room:
        B -= 1
    while B < most and peak(B + 1) <= room:
        B += 1
    return B


def dryrun_vs_card(dev, card: str) -> dict:
    """Phase 3o: the dry run's predictions held to the card (C1-C4), and
    the 16 x 16 listing from four subprocesses without the card
    (``listing_groups``).  → numbers for the summary."""
    import os
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    sms, limit = ed.sm_count(dev), ed.smem_optin_limit(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"[{card}] 3o: the card has {sms} SMs, {limit} B opt-in shared memory per block, "
          f"{total} B of memory; the dry run plans for {build.TARGET_SMS} SMs and "
          f"{build.TARGET_SMEM_OPTIN} B", flush=True)
    if (sms, limit) != (build.TARGET_SMS, build.TARGET_SMEM_OPTIN):
        raise AssertionError("3o: the dry run's target card is not this card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    (ROOT / "build").mkdir(exist_ok=True)
    logs = [open(ROOT / "build" / f"listing{i}.err", "w+") for i in range(4)]
    # niced, so that C1-C4's host work beside them keeps its core
    listings = [subprocess.Popen([sys.executable, "-c", LISTING, json.dumps(g)], cwd=ROOT,
                                 env=env, stdout=subprocess.PIPE, stderr=log, text=True,
                                 preexec_fn=lambda: os.nice(10))
                for g, log in zip(listing_groups(), logs)]
    try:
        cells = [dryrun_cell_on_card("C1", "tinyllama_1_1b", "decode_32k", {},
                                     {"elite_decode": 22, "rope_elite": 22}, dev, card)]
        # C2: the largest batch <= 32 whose predicted peak, beside what is held,
        # fills at most PREFILL_FILL of the card
        _free_card()
        build.free_scratch(dev)
        room = PREFILL_FILL * total - torch.cuda.memory_allocated(dev)
        B = largest_prefill_batch(room)
        print(f"[{card}] 3o C2: B {B} is the largest batch whose predicted peak fits "
              f"{room / 2**30:.2f} GiB", flush=True)
        cells.append(dryrun_cell_on_card("C2", "tinyllama_1_1b", "prefill_32k", {"batch": B},
                                         {"flash_prefill": 22, "rope_elite": 22}, dev, card))
        cells.append(dryrun_cell_on_card(
            "C3", "tinyllama_1_1b", "train_4k", {"batch": 8, "seq_len": 512},
            {"rope_elite": 44, "rope_elite_backward": 22}, dev, card))
        cells.append(dryrun_cell_on_card(
            "C4", "qwen3_moe_235b", "train_4k",
            {"batch": 1, "seq_len": 512, "optimizer": False, "overrides": {"num_layers": 1}},
            {"rope_elite": 2, "rope_elite_backward": 1}, dev, card))
        t_cells = time.perf_counter() - t_phase
        outs = [p.communicate(timeout=600)[0] for p in listings]
    finally:
        for p in listings:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(listings, logs):
        log.seek(0)
        err = log.read()
        log.close()
        if p.returncode != 0:
            raise AssertionError(f"3o: the 16 x 16 listing failed:\n{err[-4000:]}")
    rows = [json.loads(line) for out in outs for line in out.splitlines()
            if line.startswith("{")]
    for r in rows:
        traced = ("an even split" if r["even"] else
                  f"traced sharded: peak {r['peak'] / 2**30:.3f} GiB, collectives "
                  f"{r['colls'] / 2**30:.2f} GiB per device")
        print(f"[{card}] 3o 16x16 {r['arch']} {r['shape']}: resident "
              f"{r['resident'] / 2**30:.3f} GiB per device, {r['flops']:.4e} FLOPs per device "
              f"({traced}), {r['s']:.2f} s", flush=True)
    if len(rows) != 35:
        raise AssertionError(f"3o: {len(rows)} cells listed at 16 x 16, expected 35")
    wall = time.perf_counter() - t_phase
    print(f"[{card}] 3o: C1-C4 in {t_cells:.1f} s, the listing of {len(rows)} cells in "
          f"{sum(r['s'] for r in rows):.1f} s in four processes beside them "
          f"({sum(not r['even'] for r in rows)} traced sharded in "
          f"{sum(r['s'] for r in rows if not r['even']):.1f} s); phase wall {wall:.1f} s",
          flush=True)
    return dict(cells=cells, rows=rows, wall=wall)


# -- the sharded train and prefill steps (phase 3s) -------------------------------

#: the production mesh 3s runs on: rank 0 of 256
SHARDED_AXES = {"data": 16, "model": 16}


def predict_sharded(shape: str, room: float):
    """The dry run's record and cell of TinyLlama-1.1B's ``shape`` on the
    16 x 16 mesh at the global batch, or at the largest multiple of 16
    whose predicted per-device peak is at most ``room``.  → (record, cell,
    seconds of meta trace)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    B = dryrun.SHAPES[shape].global_batch
    while True:
        rec, cell = dryrun.lower_cell("tinyllama_1_1b", shape, batch=B, return_cell=True,
                                      mesh_axes=SHARDED_AXES)
        if B <= 16 or rec["memory"]["peak_estimate_bytes"] <= room:
            return rec, cell, time.perf_counter() - t0
        B -= 16


def sharded_cell_on_card(label: str, rec: dict, cell, t_pred: float, want: dict, dev,
                         card: str, peak_tol=None) -> dict:
    """Run the step the dry run traced for ``rec`` (TinyLlama-1.1B at full
    width and depth, sharded on the 16 x 16 mesh) on the card as rank 0 of
    a fake group of 256, the launch counts set to 0 just before it, and
    hold the measured peak (within ``peak_tol`` bytes where given, else
    max(PEAK_REL, PEAK_FLOOR)), launches and collectives to the
    prediction."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group
    from repro_torch.tree import leaves
    t_cell = time.perf_counter()
    mem, shape, batch = rec["memory"], rec["shape"], rec["global_batch"]
    plan0 = shd.plan_for_mesh(rec["mesh_axes"], fsdp=rec["fsdp"],
                              seq_parallel=rec["seq_parallel"])
    _free_card()
    build.free_scratch(dev)
    held = torch.cuda.memory_allocated(dev)
    with fake_group(plan0.chips, "cuda"):
        plan = dryrun.sharded_plan(plan0, "cuda")
        state = dryrun.place_state(cell, plan, dryrun.cell_state(cell, "meta"), device=dev,
                                   seed=5)
        placed = torch.cuda.memory_allocated(dev) - held
        constrain = dryrun.sharding_constrain(cell, plan)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t1 = time.perf_counter()
        with CommDebugMode() as cdm:
            out = dryrun.run_step(cell, state, constrain)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t1
        launches = {k: v for k, v in ops.launches().items() if v}
        counts = dryrun.comm_counts(cdm)
        peak = torch.cuda.max_memory_allocated(dev)
        outs = [getattr(t, "_local_tensor", t)
                for t in leaves(list(out) if isinstance(out, tuple) else [out])
                if torch.is_tensor(t) and t.is_floating_point()]
        finite = all(bool(torch.isfinite(part).all()) for t in outs
                     for part in t.reshape(-1).split(2**28))
        del out, state, outs
    _free_card()
    build.free_scratch(dev)
    measured = peak - held
    pred = mem["peak_estimate_bytes"]
    diff = abs(pred - measured)
    allowed = peak_tol if peak_tol is not None else max(PEAK_REL * measured, PEAK_FLOOR)
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    want_counts = {k: v["count"] for k, v in rec["collectives"].items() if v["count"]}
    print(f"[{card}] 3s {label} tinyllama_1_1b {shape} B {batch} x {cell.shape.seq_len} "
          f"({rec['step']}) on 16x16, rank 0 of a fake group of 256 (collectives move no "
          f"data, so values are not checked here): predicted peak {pred / 2**30:.3f} GiB "
          f"(resident {mem['argument_bytes'] / 2**30:.3f}, temp {mem['temp_bytes'] / 2**30:.3f} "
          f"at {mem['peak_op']}), {rec['flops_per_device']:.4e} FLOPs per device, meta trace "
          f"{t_pred:.1f} s; measured max_memory_allocated {peak / 2**30:.3f} GiB with "
          f"{held / 2**30:.3f} GiB held before the cell ({placed / 2**30:.3f} GiB placed): "
          f"{measured / 2**30:.3f} GiB, |predicted - measured| {diff / 2**20:.1f} MiB "
          f"({100 * diff / measured:.2f}%) against {allowed / 2**20:.1f} MiB allowed; step "
          f"{step_s:.2f} s (run {time.perf_counter() - t_cell:.1f} s); launches {launches}; "
          f"collectives {counts} (record: {want_counts}), "
          f"{rec['collective_bytes_per_device'] / 2**30:.2f} GiB per device", flush=True)
    for t in rec["largest_at_peak"][:4]:
        print(f"[{card}] 3s {label}   at the peak: {t['bytes'] / 2**30:.3f} GiB "
              f"{t['dtype']}{t['shape']} <- {t['op']}", flush=True)
    if launches != want or launches != calls:
        raise AssertionError(f"3s {label}: launches {launches}, expected {want} (the trace's "
                             f"meta calls {calls})")
    if counts != want_counts:
        raise AssertionError(f"3s {label}: collectives {counts} on the card, {want_counts} "
                             f"in the record")
    if not finite:
        raise AssertionError(f"3s {label}: an output is not finite")
    if diff > allowed:
        raise AssertionError(f"3s {label}: predicted peak {pred} B against {measured} B "
                             f"measured, {diff} B apart (> {allowed:.0f} B)")
    return dict(label=label, shape=shape, batch=batch, seq=cell.shape.seq_len, predicted=pred,
                measured=measured, held=held, placed=placed, raw_peak=peak,
                temp=mem["temp_bytes"], resident=mem["argument_bytes"],
                flops=rec["flops_per_device"], step_s=step_s, diff=diff,
                collectives=rec["collectives"], launches=launches,
                collective_bytes=rec["collective_bytes_per_device"], trace_s=t_pred,
                elitekv=rec["elitekv"])


def sharded_kernel_parity(dev, card: str, b1: int, b2: int) -> dict:
    """The ``local_map``ped ``rope_elite_qk`` (forward and backward) and
    ``flash_prefill`` at 3s's shard shapes (TinyLlama-1.1B on 16 x 16,
    rank 0: ``b1`` (S1) or ``b2`` (S2) lanes, 2 of 32 query heads, the 4 kv
    heads replicated) on seeded local operands, against their plain
    versions on the same operands.  ``flash_prefill`` at 4,096 positions of
    S2's 32,768: its plain version's [B, H, S, S] scores would take 17 GB
    each at 32,768."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.core.convert import pick_dims
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rope_elite as re_k
    from repro_torch.kernels.flash_prefill import prefill_cost
    from repro_torch.kernels.rope_elite import rope_cost
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    cfg = get_config("tinyllama_1_1b")
    r2 = 2 * pick_dims(cfg, 0.25, align=128).elite_r
    nh, nkv, dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_group
    hq = nh // SHARDED_AXES["model"]
    g = torch.Generator(device=dev).manual_seed(33)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    out = {}
    with fake_group(256, "cuda"):
        mesh = make_production_mesh(device_type="cuda")
        rep, bat, heads = [Replicate()] * 2, [Shard(0), Replicate()], [Shard(0), Shard(2)]
        # a rank-0 piece as a DTensor: 16 batch shards, heads over model where sharded

        def place(t, pl):
            shape = (t.shape[0] * 16, t.shape[1], t.shape[2] * (16 if pl == heads else 1),
                     t.shape[3])
            return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                      stride=torch.empty(shape, device="meta").stride())
        # S1's rotation: b1 x 4096 local lanes, q_e of 2 heads, k_e of all 4
        B1, S1 = b1, 4096
        q_l, k_l = rn(B1, S1, hq, r2), rn(B1, S1, nkv, r2)
        freqs = torch.rand(nkv, r2 // 2, generator=g, device=dev) * 0.5
        pos = torch.arange(S1, device=dev)
        qd = place(q_l.clone(), heads).requires_grad_(True)
        kd = place(k_l.clone(), bat).requires_grad_(True)
        ops.reset_launches()
        got_q, got_k = ops.rope_elite_qk(qd, kd, DTensor.from_local(pos, mesh, rep,
                                                                    run_check=False),
                                         DTensor.from_local(freqs, mesh, rep,
                                                            run_check=False), G, 1)
        wq, wk = rn(*got_q.to_local().shape), rn(*got_k.to_local().shape)
        (got_q.to_local() * wq).sum().add((got_k.to_local() * wk).sum()).backward()
        fw = ops.launches()
        qp, kp = q_l.clone().requires_grad_(True), k_l.clone().requires_grad_(True)
        # rank 0's query heads 0 .. hq-1 read kv head 0's row, the keys all rows
        want_q = ref.rope_elite_ref(qp, pos, freqs.repeat_interleave(G, 0)[:hq])
        want_k = ref.rope_elite_ref(kp, pos, freqs)
        ((want_q * wq).sum() + (want_k * wk).sum()).backward()
        out["rope"] = rope_check("3s rope_elite_qk (local_map) at S1's shard: q_e "
                                 f"{tuple(q_l.shape)} k_e {tuple(k_l.shape)}",
                                 (got_q.to_local().detach(), got_k.to_local().detach()),
                                 (want_q.detach(), want_k.detach()), card)
        e, bad, same = rope_err((qd.grad.to_local(), kd.grad.to_local()), (qp.grad, kp.grad))
        print(f"[{card}] parity 3s rope_elite_qk backward (local_map) at S1's shard: "
              f"max_abs_err={e:.3e}, {bad} outside {ROPE_ATOL:.0e} + {ROPE_RTOL:.0e}·|plain|, "
              f"bitwise equal {100 * same:.2f}%", flush=True)
        if bad:
            raise AssertionError(f"3s rope backward: {bad} elements past the tolerance")
        out["rope_backward"] = e
        # S2's attention: b2 local lanes, 2 query heads; kv heads replicated,
        # sliced to the one the shard reads
        B2, S2 = b2, 4096
        q2, k2, v2 = rn(B2, S2, hq, dh), rn(B2, S2, nkv, dh), rn(B2, S2, nkv, dh)
        offs = torch.zeros(B2 * 16, dtype=torch.int32, device=dev)
        lens = torch.full((B2 * 16,), S2, dtype=torch.int32, device=dev)
        with torch.no_grad():
            o = ops.flash_prefill(place(q2, heads), place(k2, bat), place(v2, bat), G,
                                  dh ** -0.5,
                                  DTensor.from_local(offs, mesh, rep, run_check=False),
                                  DTensor.from_local(lens, mesh, rep, run_check=False))
            want = ref.flash_prefill_ref(q2, k2[:, :, :1].contiguous(),
                                         v2[:, :, :1].contiguous(), hq, dh ** -0.5,
                                         offs[:B2], lens[:B2])
        out["flash"] = check("3s flash_prefill (local_map) at S2's shard: q "
                             f"{tuple(q2.shape)}, kv heads 1 of {nkv}",
                             max_err(o.to_local(), want), card)
        out["launches"] = {k: v for k, v in ops.launches().items() if v}
        print(f"[{card}] 3s parity launches (not counted in S1/S2): rotation forward and "
              f"backward {fw}, with flash_prefill {out['launches']}", flush=True)
        if fw != {**{k: 0 for k in fw}, "rope_elite": 1, "rope_elite_backward": 1}:
            raise AssertionError(f"3s parity: the rotation launched {fw}")
        # the kernels' times at the shard shapes: the launch each wrapper's
        # local function makes (CUDA events), the plain version on the same
        # operands, the bound; and the whole wrapper call on the host clock
        flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
        evict = lambda: flush.zero_()
        rows = freqs.repeat_interleave(G, 0)[:hq]
        x = (torch.cat([q_l, k_l], dim=2), None, pos, torch.cat([rows, freqs]))
        nb, fl = rope_cost(x)
        out["rope_row"] = dict(
            shape=f"q_e {tuple(q_l.shape)} beside k_e {tuple(k_l.shape)} as one tensor",
            ms=time_ms(lambda: re_k.rope_elite(x[0], pos, x[3]), flush=evict),
            plain_ms=time_ms(lambda: ref.rope_elite_ref(x[0], pos, x[3]), flush=evict),
            bound=bound(nb, fl), wrapper_ms=host_ms(lambda: ops.rope_elite_qk(
                qd.detach(), kd.detach(), DTensor.from_local(pos, mesh, rep, run_check=False),
                DTensor.from_local(freqs, mesh, rep, run_check=False), G, 1)))
        kv1 = dict(q=q2, k=k2[:, :, :1].contiguous(), v=v2[:, :, :1].contiguous(), G=hq,
                   scale=dh ** -0.5, offs=offs[:B2], lens=lens[:B2])
        nb, fl = prefill_cost(kv1["q"], kv1["k"], kv1["offs"], kv1["lens"])
        out["flash_row"] = dict(
            shape=f"q {tuple(q2.shape)}, k/v {tuple(kv1['k'].shape)}",
            ms=time_ms(lambda: run_prefill(kv1), flush=evict),
            plain_ms=time_ms(lambda: run_prefill(kv1, plain=True), flush=evict),
            bound=bound(nb, fl, PEAK_3XTF32_FLOPS), library_ms=time_ms(sdpa_call(kv1),
                                                                        flush=evict),
            wrapper_ms=host_ms(lambda: ops.flash_prefill(
                place(q2, heads), place(k2, bat), place(v2, bat), G, dh ** -0.5,
                DTensor.from_local(offs, mesh, rep, run_check=False),
                DTensor.from_local(lens, mesh, rep, run_check=False))))
        del flush
        for name, r in (("rope_elite", out["rope_row"]), ("flash_prefill", out["flash_row"])):
            print(f"[{card}] 3s kernel {name} at the shard's {r['shape']}: {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]})"
                  + (f", SDPA {r['library_ms']:.4f} ms" if "library_ms" in r else "")
                  + f"; the local_map wrapper's whole call {r['wrapper_ms']:.3f} ms on the "
                  f"host clock", flush=True)
    return out


def host_ms(fn, iters: int = 10) -> float:
    """Mean host-clock ms of ``fn`` to the card's idle, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


#: 3s's merge check: each lane's length over the whole 32,768-row cache (a
#: full lane, lanes ending inside a piece and on a piece boundary, short
#: lanes whose later pieces hold none of their rows, an empty lane)
MERGE_LENGTHS = (32768, 30001, 17000, 9000, 2048, 2047, 1, 0)
#: S3's |predicted - measured| peak allowed
S3_PEAK_TOL = 0.1 * 2**30


def decode_merge_check(dev, card: str, s3: dict, n_pieces: int = 16) -> dict:
    """``elite_decode`` with its log-sum-exp at S3's shard widths (8
    lanes, 32/4 heads of TinyLlama-1.1B, the dry run's EliteKV dims) over
    one seeded cache of all 32,768 rows on the card, cut into ``n_pieces``
    sequence pieces as the model axis cuts S3's cache: the pieces' (o,
    lse) merged by ``ref.merge_lse`` against one call over the whole
    cache within TOL; each piece's o and lse against the plain version
    (-inf on both sides where the piece holds none of a lane's rows), and
    o bitwise the call's without the log-sum-exp.  Then the kernel at rank
    0's piece as S3 launched it (every row valid), timed beside its plain
    version, its bound and SDPA over prebuilt operands (row 3s)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.kernels.elite_decode import contig_decode_cost
    cfg = get_config("tinyllama_1_1b")
    r2, dc = 2 * s3["elitekv"]["elite_r"], s3["elitekv"]["d_ckv"]
    nh, nkv, S = cfg.n_heads, cfg.n_kv_heads, s3["seq"]
    G, sc, B, P = nh // nkv, cfg.head_dim ** -0.5, len(MERGE_LENGTHS), S // n_pieces
    g = torch.Generator(device=dev).manual_seed(34)
    f = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q_e, q_lat, k_e, c = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc)
    lens = torch.tensor(MERGE_LENGTHS, dtype=torch.int32, device=dev)
    whole = ed.elite_decode(q_e, q_lat, k_e, c, c, lens, G, sc)
    os_, lses = [], []
    o_err = lse_err = 0.0
    empty = 0
    for i in range(n_pieces):
        k_i, c_i = k_e[:, i * P:(i + 1) * P].contiguous(), c[:, i * P:(i + 1) * P].contiguous()
        mine = (lens - i * P).clamp(0, P).to(torch.int32)
        o_i, l_i = ed.elite_decode(q_e, q_lat, k_i, c_i, c_i, mine, G, sc, return_lse=True)
        bare = ed.elite_decode(q_e, q_lat, k_i, c_i, c_i, mine, G, sc)
        po, pl = ref.elite_decode_ref(q_e, q_lat, k_i, c_i, c_i, mine, G, sc, return_lse=True)
        torch.cuda.synchronize(dev)
        if not torch.equal(o_i, bare):
            raise AssertionError(f"3s merge: piece {i}'s o moved with return_lse")
        seen = torch.isfinite(pl)
        if not torch.equal(seen, torch.isfinite(l_i)) or bool((l_i[~seen] != -torch.inf).any()):
            raise AssertionError(f"3s merge: piece {i}'s lse is not -inf exactly where the "
                                 f"plain version's is")
        empty += int((~seen[:, 0]).sum())
        o_err = max(o_err, max_err(o_i, po))
        if seen.any():
            lse_err = max(lse_err, float((l_i - pl)[seen].abs().max()))
        os_.append(o_i)
        lses.append(l_i)
    merge_err = max_err(ref.merge_lse(os_, lses), whole)
    check(f"3s elite_decode o of each of {n_pieces} pieces (return_lse) vs plain", o_err, card)
    check(f"3s elite_decode lse of each of {n_pieces} pieces vs plain", lse_err, card)
    check(f"3s merge_lse of {n_pieces} pieces of {S} rows ({empty} lane-pieces empty) vs one "
          f"unsharded call", merge_err, card)
    if float(whole[-1].abs().max()) != 0.0:
        raise AssertionError("3s merge: the empty lane did not give zeros")
    # rank 0's piece as S3 launched it: every lane's rows all valid
    full = torch.full((B,), P, dtype=torch.int32, device=dev)
    k0, c0 = k_e[:, :P].contiguous(), c[:, :P].contiguous()
    a = (q_e, q_lat, k0, c0, c0, full, G, sc)
    del k_e, c
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    evict = flush.zero_
    nb, fl = contig_decode_cost(a, lse=True)
    t_bound, by = bound(nb, fl)
    row = dict(name="elite_decode_lse", route="cuda",
               source="src/repro_torch/kernels/csrc/elite_decode_paged.cu",
               replaces=TPU_LINES["elite_decode"], launches=s3["launches"]["elite_decode"],
               max_abs_err=max(o_err, lse_err, merge_err),
               ms=time_ms(lambda: ed.elite_decode(*a, return_lse=True), flush=evict),
               plain_ms=time_ms(lambda: ref.elite_decode_ref(*a, return_lse=True),
                                flush=evict),
               bound_ms=t_bound, bound_by=by, library_ms=time_ms(contig_sdpa_call(a),
                                                                 flush=evict))
    bare_ms = time_ms(lambda: ed.elite_decode(*a), flush=evict)
    del flush
    print(f"[{card}] 3s row 3s elite_decode with return_lse at S3's shard: q_e "
          f"{tuple(q_e.shape)}, q_lat {tuple(q_lat.shape)}, k_e {tuple(k0.shape)}, c "
          f"{tuple(c0.shape)} ({B * P} rows): {row['ms']:.4f} ms ({bare_ms:.4f} ms without the "
          f"lse), plain {row['plain_ms']:.4f} ms, bound {t_bound:.5f} ms ({by}: {nb} B, {fl} "
          f"flop), SDPA {row['library_ms']:.4f} ms; launches {row['launches']} per S3 step",
          flush=True)
    return dict(row=row, o_err=o_err, lse_err=lse_err, merge_err=merge_err, bare_ms=bare_ms,
                empty=empty)


def sharded_steps(dev, card: str) -> dict:
    """Phase 3s: the sharded train, prefill and decode steps of
    TinyLlama-1.1B at full width and depth on the 16 x 16 mesh, as rank 0
    of a fake group of 256 on the card (S1 train_4k, S2 prefill_32k, S3
    decode_32k with the cache sequence over "model"), held to the dry run's
    prediction; the two kernels' ``local_map`` wrappers at the shard shapes
    held to their plain versions; and the decode kernel's log-sum-exp merge
    of 16 sequence pieces held to one call (``decode_merge_check``)."""
    import torch
    t_phase = time.perf_counter()
    _free_card()
    total = torch.cuda.get_device_properties(dev).total_memory
    room = PREFILL_FILL * total - torch.cuda.memory_allocated(dev)
    cells = []
    for label, shape, want, tol in (
            ("S1", "train_4k", {"rope_elite": 44, "rope_elite_backward": 22}, None),
            ("S2", "prefill_32k", {"flash_prefill": 22, "rope_elite": 22}, None),
            ("S3", "decode_32k", {"elite_decode": NUM_LAYERS, "rope_elite": NUM_LAYERS},
             S3_PEAK_TOL)):
        rec, cell, t_pred = predict_sharded(shape, room)
        cells.append(sharded_cell_on_card(label, rec, cell, t_pred, want, dev, card,
                                          peak_tol=tol))
    parity = sharded_kernel_parity(dev, card, cells[0]["batch"] // 16, cells[1]["batch"] // 16)
    merge = decode_merge_check(dev, card, cells[2])
    _free_card()
    wall = time.perf_counter() - t_phase
    print(f"[{card}] phase 3s (the sharded train, prefill and decode steps) {wall:.1f} s",
          flush=True)
    return dict(cells=cells, parity=parity, merge=merge, wall=wall)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.elite_decode import (contig_decode_cost, decode_cost, scored_pairs,
                                                  split_decode, visited_rows)
    from repro_torch.kernels.flash_prefill import prefill_cost
    from repro_torch.kernels.rope_elite import rope_cost
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import elite_decode as ed
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import rope_elite as re_k
    from repro_torch.launch.serve import build_config, make_stream
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    SchedulerConfig = serve_loop.SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        for inst, regs, spills in ptxas_summary(text):
            print(f"  {name}: {inst}: {regs} registers, {spills}")
    # all shared memory is dynamic (ptxas reports none): the bytes per CTA
    # of the plans at the widths below, from the host's formula, which must
    # be the kernel source's layout
    limit, sms = ed.smem_optin_limit(dev), ed.sm_count(dev)
    print(f"  shared memory opt-in limit per block: {limit} B; {sms} SMs")
    for wname, (G, nkv, r2, dc) in {"tinyllama_1_1b": (8, 4, 16, 64),
                                    "llama2_7b": (1, 32, 32, 1024)}.items():
        for sep in (0, 1):
            for q8 in (False, True):
                for w in (1, 5):
                    p = ed.plan(8, w, G, nkv, 16, r2, dc, not sep, q8, 72, sms, limit)
                    built = ed.smem_bytes_built(w, G, p.heads, 16, r2, dc, not sep, q8,
                                                p.stages)
                    if built != p.smem:
                        raise AssertionError(f"smem formula {p.smem} B != kernel's {built} B")
                    print(f"  plan {wname} {'S' if sep else 'J'}-LRD {'int8' if q8 else 'f32'} "
                          f"{'decode' if w == 1 else f'verify W={w}'} (8 lanes, 72 tiles): "
                          f"{p.heads} kv heads ({w * G * p.heads} query rows) per CTA, "
                          f"{p.stages} stages, {p.smem} B/CTA, {p.splits} splits of "
                          f"{p.tiles_per_split} tiles, {p.ctas} CTAs")
    cuts = arch_plans(limit, sms)
    print(f"  {len(cuts)} of those plans cut the window (one kv head's rows of it do not "
          f"fit): {cuts}")
    for want in (("llama2_13b", 0.5, "J-LRD", "f32", 5), ("llama2_13b", 0.5, "J-LRD", "int8", 5),
                 ("llama2_7b", 0.5, "J-LRD", "f32", 9)):
        if not any(c[:5] == want for c in cuts):
            raise AssertionError(f"the plan of {want} did not cut the window")
    for body in fp.BODIES:
        for dh in fp.HEAD_DIMS:
            want, built = fp.smem_bytes(body, dh), fp.smem_bytes_built(body, dh)
            if built != want:
                raise AssertionError(f"flash_prefill {body} dh={dh}: smem formula {want} B "
                                     f"!= kernel's {built} B")
            print(f"  flash_prefill {body} body smem/CTA dh={dh}: {want} B")
    for label, shape in FLASH_SHAPES.items():
        print(f"  flash_prefill plan, {label} (B, Sq, Sk, nh, nkv) = {shape}: "
              f"{fp.plan(*shape)}")
    print(f"  elite_decode (contiguous) reads tiles of {ed.CONTIG_TILE} rows: the decode "
          f"entries' plan at block_size {ed.CONTIG_TILE}; rope_elite uses no shared memory")

    # -- 2. kernel parity at both model widths ------------------------------
    errs = dict.fromkeys(DECODES + VERIFIES + ("flash_prefill", "elite_decode",
                                               "rope_elite"), 0.0)
    widths = {"tinyllama_1_1b": (32, 4, 16, 64, 64), "llama2_7b": (32, 32, 32, 1024, 128)}
    for i, (wname, (nh, nkv, r2, dc, dh)) in enumerate(widths.items()):
        for separate in (False, True):
            x = random_decode(dev, nh, nkv, r2, dc, separate, seed=i)
            sel = random_selection(x, W=24, seed=i)
            for name in DECODES:
                a = decode_call(name, x, dh, sel)
                got = run_decode(name, a)
                e = check(f"{name} {wname} {'S-LRD' if separate else 'J-LRD'}",
                          max_err(got, run_decode(name, a, plain=True)), card)
                if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                    raise AssertionError(f"{name}: an empty lane did not give exact zeros")
                errs[name] = max(errs[name], e)
            # a full-width selection is the whole chain: the dense bits
            mb = x["bt"].shape[1]
            summ = torch.randn(x["k_e"].shape[0] // x["bs"], dc, device=dev)
            full = ref.select_topk_blocks(x["q_lat"], summ, summ.abs(), x["bt"],
                                          x["lengths"], x["bs"], mb, 2)
            if not torch.equal(full[0], x["bt"]):
                raise AssertionError("a full-width selection is not the block table")
            for sfx in ("", "_q8"):
                dense = run_decode("elite_decode_paged" + sfx,
                                   decode_call("elite_decode_paged" + sfx, x, dh))
                sparse = run_decode("elite_decode_sparse_paged" + sfx,
                                    decode_call("elite_decode_sparse_paged" + sfx, x, dh, full))
                torch.cuda.synchronize()
                if not torch.equal(sparse, dense):
                    raise AssertionError(f"full-width sparse{sfx} != dense{sfx} ({wname})")
            print(f"[{card}] full-width sparse == dense bitwise, f32 and int8, {wname} "
                  f"{'S-LRD' if separate else 'J-LRD'}", flush=True)
            # verify windows of 1, 3 and 5 tokens
            for W in (1, 3, 5):
                xv = random_verify(dev, nh, nkv, r2, dc, separate, W, seed=20 + W + i)
                for name in VERIFIES:
                    a = decode_call(name, xv, dh)
                    got = run_decode(name, a)
                    e = check(f"{name} W={W} {wname} {'S-LRD' if separate else 'J-LRD'}",
                              max_err(got, run_decode(name, a, plain=True)), card)
                    if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                        raise AssertionError(f"{name}: a dead lane did not give exact zeros")
                    errs[name] = max(errs[name], e)
            # a window of one token at q_offsets = lengths - 1 is decode, bit for bit
            offs = (x["lengths"] - 1).clamp(min=0)
            for sfx in ("", "_q8"):
                a = decode_call("elite_decode_paged" + sfx, x, dh)
                n = len(a) - 5                        # index of block_tables
                va = (a[0][:, None].contiguous(), a[1][:, None].contiguous(), *a[2:n + 1],
                      offs, *a[n + 1:])
                dense = run_decode("elite_decode_paged" + sfx, a)
                one = run_decode("elite_verify_paged" + sfx, va)
                torch.cuda.synchronize()
                if not torch.equal(one[:, 0], dense):
                    raise AssertionError(f"verify W=1{sfx} != decode{sfx} ({wname})")
            print(f"[{card}] verify W=1 == decode bitwise, f32 and int8, {wname} "
                  f"{'S-LRD' if separate else 'J-LRD'}", flush=True)
            # the contiguous cache: plain version, and the paged bits
            for S in (1000, 1152):
                a = random_contig(dev, nh, nkv, r2, dc, separate, S, seed=30 + S + i)
                a = a + (dh ** -0.5,)
                got = ed.elite_decode(*a)
                lrd = "S-LRD" if separate else "J-LRD"
                errs["elite_decode"] = max(errs["elite_decode"], check(
                    f"elite_decode S={S} {wname} {lrd}",
                    max_err(got, ref.elite_decode_ref(*a)), card))
                if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                    raise AssertionError("elite_decode: a length-0 lane did not give zeros")
                paged = ed.elite_decode_paged(*as_identity_pages(a))
                torch.cuda.synchronize()
                if not torch.equal(got, paged):
                    raise AssertionError(f"elite_decode != elite_decode_paged over identity "
                                         f"pages (S={S}, {wname} {lrd})")
            print(f"[{card}] elite_decode == elite_decode_paged on identity-table pages "
                  f"bitwise, S=1000 and 1152, {wname} {lrd}", flush=True)
        x = random_prefill(dev, nh, nkv, dh, seed=10 + i)
        got = run_prefill(x)
        e = check(f"flash_prefill {wname}", max_err(got, run_prefill(x, plain=True)), card)
        if float(got[-1].abs().max()) != 0.0:
            raise AssertionError("a kv_len = 0 lane did not give exact zeros")
        errs["flash_prefill"] = max(errs["flash_prefill"], e)
        # both bodies: Sq of 1, 2, 8, 100, 256, 1024, ragged lanes, kv_len = 0
        for label, x in flash_cases(dev, nh, nkv, dh, seed=50 + i).items():
            body = fp.plan_for(x["q"], x["k"], x["v"], x["G"], x["scale"], x["offs"],
                               x["lens"]).body
            got = run_prefill(x)
            errs["flash_prefill"] = max(errs["flash_prefill"], check(
                f"flash_prefill {body} body {wname} {label}",
                max_err(got, run_prefill(x, plain=True)), card))
            if float(got[3].abs().max()) != 0.0:
                raise AssertionError("a kv_len = 0 lane did not give exact zeros")
            if not torch.equal(got, run_prefill(x)):
                raise AssertionError(f"flash_prefill {label}: two calls differ")
        lane_invariance(dev, card, wname, nh, nkv, r2, dc, dh)
    for entry, cases, kernel, plain in (
            ("rope_elite", rope_cases(dev, seed=40), re_k.rope_elite, ref.rope_elite_ref),
            ("rope_elite_qk", rope_pair_cases(dev, seed=41), re_k.rope_elite_qk,
             ref.rope_elite_qk_ref),
            ("rope_elite_qk", rope_pair_cases(dev, seed=42, cases=ARCH_ROPE_PAIR_CASES),
             re_k.rope_elite_qk, ref.rope_elite_qk_ref)):
        for label, a in cases.items():
            errs["rope_elite"] = max(errs["rope_elite"], rope_check(
                f"{entry} {label}", kernel(*a), plain(*a), card))
    # the other architectures' widths: decode and verify (LLaMA2-13B at half
    # cache cuts its verify windows), and flash_prefill at 40/40 heads and at
    # Qwen3-MoE's 64/4, Jamba's 32/8 and Arctic's 56/8 heads of 128
    t0 = time.perf_counter()
    arch_parity(dev, card, errs)
    wide = {}
    for i, (tag, nh, nkv) in enumerate((("40/40", 40, 40), ("Qwen3-MoE 64/4", 64, 4),
                                        ("Jamba 32/8", 32, 8), ("Arctic 56/8", 56, 8))):
        wide[f"{tag} dh=128"] = random_prefill(dev, nh, nkv, 128, seed=90 + 2 * i)
        wide.update({f"{tag} dh=128 {k}": v for k, v in flash_cases(
            dev, nh, nkv, 128, seed=91 + 2 * i).items()})
    for label, x in wide.items():
        got = run_prefill(x)
        errs["flash_prefill"] = max(errs["flash_prefill"], check(
            f"flash_prefill {label}", max_err(got, run_prefill(x, plain=True)), card))
        if float(got[3].abs().max()) != 0.0:
            raise AssertionError("a kv_len = 0 lane did not give exact zeros")
    del wide, got
    print(f"[{card}] phase 2 at the other architectures' widths: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # o. the dry run against the card, while the card holds next to nothing
    dry = dryrun_vs_card(dev, card)

    # -- 3. the main paths at full width ------------------------------------
    cfg = build_config("tinyllama_1_1b", reduced=False, cache_ratio=0.25)
    e = cfg.elitekv
    assert (cfg.num_layers, cfg.d_model, e.elite_r, e.d_ckv) == (NUM_LAYERS, 2048, 8, 64), cfg
    params, buffers = lm.init(cfg, seed=0, device=dev)
    base = dict(max_slots=8, block_size=16, num_blocks=8 * 64, max_new_tokens=128,
                max_len=1024, prefill_chunk_tokens=256, prefill_batch_lanes=8)
    runs, recs = {}, {}
    # a. the f32 pool, dense decode
    reqs = make_stream(cfg, 24, rate=0.5, prompt_len=768, new_tokens=128, seed=0,
                       prompt_min=64, new_min=32)
    rep, launches, rec, sched = serve_run(
        "main path f32 24 requests", params, buffers, cfg,
        serve_loop.SchedulerConfig(**base), reqs, card)
    f32_streams = {r.uid: r.generated for r in sched.finished}
    runs["elite_decode_paged"] = rep, launches
    recs["elite_decode_paged"] = rec
    # b. the int8 pool with sparse decode; c. int8 dense and f32 sparse
    sparse = dict(sparse_topk_blocks=4, sparse_recent_blocks=2, admission="watermark")
    for decode, label, n, seed, kw in (
            ("elite_decode_sparse_paged_q8", "int8 + sparse k=4+2", 16, 4,
             dict(cache_dtype="int8", **sparse)),
            ("elite_decode_paged_q8", "int8 dense", 6, 5, dict(cache_dtype="int8")),
            ("elite_decode_sparse_paged", "f32 + sparse k=4+2", 6, 6, sparse)):
        reqs = make_stream(cfg, n, rate=0.5, prompt_len=768, new_tokens=128, seed=seed,
                           prompt_min=512, new_min=64)
        rep, launches, rec, sched = serve_run(
            f"{label} {n} requests", params, buffers, cfg,
            serve_loop.SchedulerConfig(**base, **kw), reqs, card)
        runs[decode], recs[decode] = (rep, launches), rec
        if "sparse" in decode and not rep.mean_selected_blocks < rep.mean_candidate_blocks:
            raise AssertionError(f"{label}: the selection was never partial")
        if decode.endswith("q8") and rep.pool_dtype != "int8":
            raise AssertionError(f"{label}: pool dtype {rep.pool_dtype}")

    # e. greedy self-speculative decode against plain decode on the same
    # requests: f32 pool with the full-rank and a rank-32 draft, int8 pool
    # with the rank-32 draft
    spec_runs = {}
    for pool, n, seed, kw in (("f32", 12, 7, {}), ("int8", 6, 8, dict(cache_dtype="int8"))):
        stream = lambda: make_stream(cfg, n, rate=0.5, prompt_len=512, new_tokens=128,
                                     seed=seed, prompt_min=64, new_min=64)
        prep, _, _, psched = serve_run(f"{pool} plain {n} requests", params, buffers, cfg,
                                       serve_loop.SchedulerConfig(**base, **kw), stream(),
                                       card)
        spec_runs[f"{pool} plain"] = prep
        verify = "elite_verify_paged" + ("_q8" if kw else "")
        for rank in ((0, 32) if pool == "f32" else (32,)):
            label = f"{pool} spec k=4 r={rank or 'full'}"
            srep, launches, rec, ssched = serve_run(
                f"{label} {n} requests", params, buffers, cfg,
                serve_loop.SchedulerConfig(**base, **kw, speculate_k=4, draft_rank=rank),
                stream(), card)
            spec_runs[label] = srep
            compare_streams(label, sched_streams(psched, ssched), params, buffers, cfg,
                            dev, card)
            if rank == 0 and not (srep.acceptance_rate >= 0.99
                                  and srep.tokens_per_forward > 2):
                raise AssertionError(f"{label}: acceptance {srep.acceptance_rate} and "
                                     f"{srep.tokens_per_forward} tokens per forward")
            if rank:                     # the verify kernel's row: the rank-32 run
                runs[verify], recs[verify] = (srep, launches), rec

    # f. lockstep generate over a contiguous cache, EliteKV and baseline
    L, B_GEN, P_GEN, N_GEN = NUM_LAYERS, 8, 1024, 128
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (B_GEN, P_GEN))
    gen = {}
    out, gstats, gwall, grec, glaunches = generate_run(
        "generate EliteKV", params, buffers, cfg, prompts, N_GEN,
        {"elite_decode": L * (N_GEN - 1), "flash_prefill": L, "rope_elite": L * N_GEN},
        card)
    gen["EliteKV"] = gstats, gwall
    paged, _ = serve_loop.generate_paged(params, buffers, cfg, prompts, N_GEN, device=dev)
    compare_streams("generate EliteKV vs generate_paged",
                    [(b, prompts[b], out[b], paged[b]) for b in range(B_GEN)],
                    params, buffers, cfg, dev, card, against="generate_paged's")
    bcfg = build_config("tinyllama_1_1b", reduced=False, cache_ratio=0.25, elitekv=False)
    bparams, bbuffers = lm.init(bcfg, seed=0, device=dev)
    _, bstats, bwall, brec, _ = generate_run(
        "generate baseline GQA", bparams, bbuffers, bcfg, prompts, N_GEN,
        {"flash_prefill": L * N_GEN, "rope_elite": L * N_GEN}, card)
    gen["baseline GQA"] = bstats, bwall
    del bparams, bbuffers
    print(f"[{card}] measured cache: EliteKV {gstats.cache_bytes} B vs baseline "
          f"{bstats.cache_bytes} B (ratio {gstats.cache_bytes / bstats.cache_bytes:.4f}); "
          f"per token {gstats.cache_bytes // (B_GEN * (P_GEN + N_GEN))} vs "
          f"{bstats.cache_bytes // (B_GEN * (P_GEN + N_GEN))} B", flush=True)

    # g. sampled serving, the prefix cache and host swap
    feats = serving_features(params, buffers, cfg, dev, card, base)
    # h. the same runs traced, the spans against the profiler, the cost
    observability(params, buffers, cfg, dev, card, {
        "f32 24 requests": (SchedulerConfig(**base), make_stream(
            cfg, 24, rate=0.5, prompt_len=768, new_tokens=128, seed=0, prompt_min=64,
            new_min=32), f32_streams, runs["elite_decode_paged"][0]),
        "sampled swap 12 requests": (SchedulerConfig(**dict(
            base, num_blocks=160, eviction="swap")), make_stream(
            cfg, 12, rate=0.5, prompt_len=512, new_tokens=128, seed=10, prompt_min=64,
            new_min=64, temperature=0.8, top_p=0.95, sample_seed=100),
            feats["streams swap"], feats["tight swap"]),
        "sampled prefix cache on 16 requests": (SchedulerConfig(**base, prefix_cache=True),
                                                make_stream(
            cfg, 16, rate=0.5, prompt_len=256, new_tokens=128, seed=11, prompt_min=64,
            new_min=64, shared_prefix=256, temperature=0.8, top_p=0.95, sample_seed=200),
            feats["streams prefix on"], feats["prefix on"])})

    # p. the data-parallel router: two replicas sharing the card against one
    # Scheduler, every sharded_check scenario and a sampled one
    dp3p = data_parallel(params, buffers, cfg, dev, card)
    # q. tensor-parallel attention: the paged forwards at tp 1, 2 and 4 on
    # a TPMesh of the card, bitwise equal
    tp3q = tensor_parallel(params, buffers, cfg, dev, card)
    # r. tensor-parallel serving: 3p's runs through Scheduler(mesh=) at tp 2
    # and 4 and Router(meshes=) at tp 2 x dp 2, bitwise equal to 3p's
    tp3r = tp_serving(params, buffers, cfg, dev, card, dp3p.pop("handoff"))
    # s. the sharded train, prefill and decode steps on the 16 x 16 mesh as
    # rank 0 of a fake group of 256, held to the dry run's per-device
    # prediction, and the decode kernel's log-sum-exp merge of 16 pieces
    sh3s = sharded_steps(dev, card)

    # i. conversion of the baseline TinyLlama-1.1B, and the converted model
    # served; k. that model uptrained, resumed and served; j. MiniCPM-2B
    # (tied embeddings) served plain and speculative
    conv, converted = conversion(dev, card)
    train3k = training(dev, card, *converted)
    del converted
    tied = tied_model(dev, card)

    # each decode and verify kernel again, on the busiest recorded main-path inputs
    busiest = {}
    for name in DECODES + VERIFIES:
        calls = recs[name].calls[name]
        i = max(range(len(calls)), key=lambda k: visited_rows(name, calls[k]))
        busiest[name] = calls[i], i
        got = run_decode(name, calls[i])
        errs[name] = max(errs[name], check(
            f"{name} on main-path pages",
            max_err(got, run_decode(name, calls[i], plain=True)), card))
        if not torch.equal(got, run_decode(name, calls[i])):
            raise AssertionError(f"{name}: two calls on the same inputs differ")
    calls = grec.calls["elite_decode"]
    busiest["elite_decode"] = max(calls, key=lambda a: int(a[5].sum())), 0
    a = busiest["elite_decode"][0]
    got = ed.elite_decode(*a)
    errs["elite_decode"] = max(errs["elite_decode"], check(
        "elite_decode on the generate run's cache",
        max_err(got, ref.elite_decode_ref(*a)), card))
    if not torch.equal(got, ed.elite_decode(*a)):
        raise AssertionError("elite_decode: two calls on the same inputs differ")
    print(f"[{card}] every decode and verify entry: two calls on its busiest main-path "
          f"inputs give identical bits", flush=True)
    # rope_elite_qk at four recorded inputs: generate's prefill and one
    # decode step, EliteKV and baseline (the full RoPE)
    rope_x = {}
    for model, r in (("EliteKV", grec), ("baseline", brec)):
        calls = r.calls["rope_elite_qk"]
        rope_x[f"{model} prefill"] = max(calls, key=lambda a: a[0].numel())
        rope_x[f"{model} decode"] = calls[-1]
    for label, a in rope_x.items():
        errs["rope_elite"] = max(errs["rope_elite"], rope_check(
            f"rope_elite_qk on the generate run's {label} q {tuple(a[0].shape)} "
            f"k {tuple(a[1].shape)}", re_k.rope_elite_qk(*a), ref.rope_elite_qk_ref(*a),
            card))
    # flash_prefill at its three main-path inputs: the f32 run's busiest
    # prefill chunk, generate's 8 x 1024 prefill, the baseline's busiest decode
    as_x = lambda a: dict(q=a[0], k=a[1], v=a[2], G=a[3], scale=a[4], offs=a[5], lens=a[6])
    flash_x = {
        "paged chunk": as_x(max(recs["elite_decode_paged"].calls["flash_prefill"],
                                key=lambda a: int(a[6].sum()))),
        "generate prefill": as_x(grec.calls["flash_prefill"][0]),
        "baseline decode": as_x(max((c for c in brec.calls["flash_prefill"]
                                     if c[0].shape[1] == 1), key=lambda c: int(c[6].sum())))}
    flash_launches = {"paged chunk": runs["elite_decode_paged"][1]["flash_prefill"],
                      "generate prefill": glaunches["flash_prefill"],
                      "baseline decode": L * (N_GEN - 1)}
    for label, x in flash_x.items():
        got = run_prefill(x)
        errs["flash_prefill"] = max(errs["flash_prefill"], check(
            f"flash_prefill on the {label} input", max_err(got, run_prefill(x, plain=True)),
            card))
        if not torch.equal(got, run_prefill(x)):
            raise AssertionError(f"flash_prefill {label}: two calls differ")
    saved = {name: (name, busiest[name][0]) for name in ("elite_decode",) + DECODES + VERIFIES}
    saved.update({f"flash_prefill {label}": ("flash_prefill", (
        x["q"], x["k"], x["v"], x["G"], x["scale"], x["offs"], x["lens"]))
        for label, x in flash_x.items()})
    saved.update({f"rope_elite_qk {label}": ("rope_elite_qk", a)
                  for label, a in rope_x.items()})
    # copies with the recorded strides (the q_e slice stays a strided view)
    keep = lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                         device=t.device).copy_(t)
    PHASE4_INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: (n, tuple(keep(t) if torch.is_tensor(t) else t for t in a))
                for k, (n, a) in saved.items()}, PHASE4_INPUTS)

    # a one-shot run on a tight pool must preempt and still finish everything
    tight = serve_loop.SchedulerConfig(max_slots=4, block_size=16, num_blocks=40,
                                       max_new_tokens=96, max_len=384)
    small = make_stream(cfg, 6, rate=4.0, prompt_len=256, new_tokens=96, seed=1,
                        prompt_min=64, new_min=64)
    srep = serve_loop.Scheduler(params, buffers, cfg, tight, device=dev).run(small)
    print(f"[{card}] tight pool one-shot: {srep.summary()}", flush=True)
    if srep.completed != len(small) or srep.preemptions < 1:
        raise AssertionError("the tight-pool run must finish all requests and preempt")
    profile_decode(params, buffers, cfg, dev, card, "f32 dense")
    profile_decode(params, buffers, cfg, dev, card, "int8 + sparse k=4+2", cache_dtype="int8",
                   sparse_topk_blocks=4, sparse_recent_blocks=2, admission="watermark")
    profile_decode(params, buffers, cfg, dev, card, "f32 spec k=4 full-rank draft",
                   speculate_k=4)
    del params, buffers

    # a narrow model on the card gives the CPU's tokens (plain versions
    # there), on the f32 pool and on the int8 pool with sparse decode
    ncfg = build_config("tinyllama_1_1b", reduced=True, cache_ratio=0.25)
    cp, cb = lm.init(ncfg, seed=3, device="cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else \
        [to(v) for v in t] if isinstance(t, list) else t.to(dev)
    prompts = np.random.default_rng(3).integers(0, ncfg.vocab_size, (3, 24))
    spec = dict(speculate_k=2, draft_rank=16)
    for label, kw in (("f32", {}), ("int8 + sparse k=1+1",
                                    dict(cache_dtype="int8", sparse_topk_blocks=1,
                                         sparse_recent_blocks=1, admission="watermark")),
                      ("f32 + spec k=2 r=16", spec),
                      ("int8 + spec k=2 r=16", dict(cache_dtype="int8", **spec))):
        nscfg = serve_loop.SchedulerConfig(max_slots=3, block_size=8, num_blocks=64,
                                           max_len=64, prefill_chunk_tokens=16, **kw)
        want, _ = serve_loop.generate_paged(cp, cb, ncfg, prompts, 12, nscfg, device="cpu")
        got, nrep = serve_loop.generate_paged(to(cp), to(cb), ncfg, prompts, 12, nscfg,
                                              device=dev)
        if not np.array_equal(got, want):
            raise AssertionError(f"narrow model {label}: card tokens {got.tolist()} "
                                 f"!= CPU tokens {want.tolist()}")
        print(f"narrow model {label}: card tokens == CPU tokens", flush=True)
    # sampled requests behind a shared prefix, prefix cache on, on a pool
    # tight enough to swap
    nscfg = serve_loop.SchedulerConfig(max_slots=3, block_size=8, num_blocks=12, max_len=64,
                                       prefill_chunk_tokens=16, prefix_cache=True,
                                       eviction="swap")
    nstreams = {}
    for where, (p_, b_) in (("cpu", (cp, cb)), (dev, (to(cp), to(cb)))):
        sched = serve_loop.Scheduler(p_, b_, ncfg, nscfg, device=where)
        nrep = sched.run(make_stream(ncfg, 5, rate=1.0, prompt_len=16, new_tokens=12, seed=3,
                                     prompt_min=8, new_min=12, shared_prefix=24,
                                     temperature=0.8, top_p=0.9, sample_seed=40))
        nstreams[str(where)] = {r.uid: r.generated for r in sched.finished}
        if not (nrep.swap_outs > 0 and nrep.prefix_cache_hit_tokens > 0):
            raise AssertionError(f"narrow sampled run on {where}: swaps {nrep.swap_outs}, "
                                 f"hit tokens {nrep.prefix_cache_hit_tokens}")
    if nstreams["cpu"] != nstreams[str(dev)]:
        raise AssertionError(f"narrow model sampled + prefix cache + swap: card tokens "
                             f"{nstreams[str(dev)]} != CPU tokens {nstreams['cpu']}")
    print(f"narrow model sampled + prefix cache + swap ({nrep.swap_outs} swap-outs, "
          f"{nrep.prefix_cache_hit_tokens} hit tokens): card tokens == CPU tokens", flush=True)
    for label, elitekv in (("EliteKV", True), ("baseline GQA", False)):
        gcfg = build_config("tinyllama_1_1b", reduced=True, cache_ratio=0.25,
                            elitekv=elitekv)
        gp, gb = lm.init(gcfg, seed=3, device="cpu")
        want, _ = serve_loop.generate(gp, gb, gcfg, prompts, 12, device="cpu")
        got, _ = serve_loop.generate(to(gp), to(gb), gcfg, prompts, 12, device=dev)
        if not np.array_equal(got, want):
            raise AssertionError(f"narrow model generate {label}: card tokens "
                                 f"{got.tolist()} != CPU tokens {want.tolist()}")
        print(f"narrow model generate {label}: card tokens == CPU tokens", flush=True)

    # l. MoE, Mamba and hybrid stacks at full width, each model freed before
    # the next is made (every earlier phase's model is gone by now)
    hyb = moe_mamba_hybrid(dev, card)
    # m. the vision and audio frontends at full width and depth
    fronts = frontends(dev, card)
    # n. training and conversion of MoE, Mamba and hybrid stacks
    tr3n = moe_mamba_training(dev, card)

    # -- 4. times at the main paths' shapes ----------------------------------
    scratch = torch.empty(64 * 2**20 // 4, device=dev)      # > the 50 MB L2
    flush = scratch.zero_
    rows = []
    for name in DECODES + VERIFIES:
        a = busiest[name][0]
        d_bytes, d_flops = decode_cost(name, a)
        d_bound, d_by = bound(d_bytes, d_flops)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/elite_decode_paged.cu",
            replaces=TPU_LINES[name], launches=runs[name][1][name],
            max_abs_err=errs[name],
            ms=time_ms(lambda: run_decode(name, a), flush=flush),
            plain_ms=time_ms(lambda: run_decode(name, a, plain=True), flush=flush),
            bound_ms=d_bound, bound_by=d_by, library_ms=None))
        q_e, _, (k_e, c_k, _), _, table, offs, cnt, G, bs = split_decode(name, a)
        window = "" if offs is None else f"W={q_e.shape[1]} q_offsets={offs.tolist()} "
        print(f"[{card}] {name} shapes: B={q_e.shape[0]} {window}"
              f"{'counts' if 'sparse' in name else 'lengths'}="
              f"{cnt.sum(-1).tolist() if 'sparse' in name else cnt.tolist()} "
              f"visited rows {visited_rows(name, a)}, scored pairs {scored_pairs(name, a)}, "
              f"nh={q_e.shape[-2]} nkv={k_e.shape[1]} "
              f"2r={k_e.shape[2]} d_c={c_k.shape[-1]} {k_e.dtype}; bound: {d_bytes} B / "
              f"3.35 TB/s vs {d_flops} flop / 67 TFLOP/s; {plan_line(ed.plan_for(name, a, sms, limit))}",
              flush=True)
    for r in rows:
        a = busiest[r["name"]][0]
        print(f"[{card}] {r['name']}: {r['ms']:.4f} ms with the launch queued ahead, "
              f"{time_ms(lambda: run_decode(r['name'], a), flush=flush, ahead=False):.4f} ms "
              f"counting the wrapper's host time", flush=True)
    # flash_prefill at its three main-path inputs; the JSON row is the paged
    # chunk's.  The prefill body's bound is at the tensor cores' 3xTF32 rate,
    # the decode body's at the f32 rate (bytes bound it either way)
    for label, x in flash_x.items():
        nbytes, flops = prefill_cost(x["q"], x["k"], x["offs"], x["lens"])
        body = fp.plan_for(x["q"], x["k"], x["v"], x["G"], x["scale"], x["offs"],
                           x["lens"]).body
        t_f32, by_f32 = bound(nbytes, flops)
        t_bound, by_bound = bound(nbytes, flops, PEAK_3XTF32_FLOPS if body == "prefill"
                                  else PEAK_F32_FLOPS)
        r = dict(name="flash_prefill", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                 replaces="src/repro/kernels/flash_prefill.py:126",
                 launches=flash_launches[label], max_abs_err=errs["flash_prefill"],
                 ms=time_ms(lambda: run_prefill(x), flush=flush),
                 plain_ms=time_ms(lambda: run_prefill(x, plain=True), flush=flush),
                 bound_ms=t_bound, bound_by=by_bound,
                 library_ms=time_ms(sdpa_call(x), flush=flush))
        if label == "paged chunk":
            rows.insert(1, r)
        print(f"[{card}] flash_prefill {label} ({body} body): q={tuple(x['q'].shape)} "
              f"k={tuple(x['k'].shape)} q_offsets={x['offs'].tolist()} "
              f"kv_lens={x['lens'].tolist()}: kernel {r['ms']:.4f} ms (PR 11's body: "
              f"{FLASH_EARLIER_MS[label]} ms), plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {t_bound:.5f} ms ({by_bound}; at the f32 "
              f"rate {t_f32:.5f} ms, {by_f32}): {nbytes} B, {flops} flop; launches "
              f"{flash_launches[label]}", flush=True)
    # the contiguous decode at the generate run's busiest call, against one
    # SDPA call over the same scores: prebuilt [q_e | q_lat] and
    # [K_e | C_k] (the latent broadcast to the kv heads) with values C_v and
    # a boolean length mask; only the SDPA call is timed, not the builds
    a = busiest["elite_decode"][0]
    q_e, q_lat, k_e, c_k, c_v, lens, G, sc = a
    B, S = k_e.shape[:2]
    nkv, dc = k_e.shape[2], c_k.shape[-1]
    sdpa_d = contig_sdpa_call(a)
    print(f"[{card}] elite_decode vs its SDPA yardstick: max abs difference "
          f"{max_err(sdpa_d()[:, :, 0], ed.elite_decode(*a)):.3e}", flush=True)
    e_bytes, e_flops = contig_decode_cost(a)
    e_bound, e_by = bound(e_bytes, e_flops)
    rows.insert(2, dict(
        name="elite_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/elite_decode_paged.cu",
        replaces=TPU_LINES["elite_decode"], launches=glaunches["elite_decode"],
        max_abs_err=errs["elite_decode"],
        ms=time_ms(lambda: ed.elite_decode(*a), flush=flush),
        plain_ms=time_ms(lambda: ref.elite_decode_ref(*a), flush=flush),
        bound_ms=e_bound, bound_by=e_by, library_ms=time_ms(sdpa_d, flush=flush)))
    print(f"[{card}] elite_decode shapes: B={B} S={S} lengths={lens.tolist()} "
          f"({int(lens.clamp(max=S).sum())} rows) nh={q_e.shape[1]} nkv={nkv} "
          f"2r={k_e.shape[-1]} d_c={dc}; bound: {e_bytes} B / 3.35 TB/s vs {e_flops} "
          f"flop / 67 TFLOP/s; {plan_line(ed.plan_for('elite_decode', a, sms, limit))}", flush=True)
    # rope_elite_qk at its four recorded inputs, beside two launches of the
    # one-tensor entry (the callers before the q-and-k entry); the JSON row
    # is the EliteKV prefill's
    rope_launches = {"prefill": L, "decode": L * (N_GEN - 1)}
    for label, a in rope_x.items():
        r_bytes, r_flops = rope_cost(a)
        r_bound, r_by = bound(r_bytes, r_flops)
        r = dict(name="rope_elite", route="cuda",
                 source="src/repro_torch/kernels/csrc/rope_elite.cu",
                 replaces=TPU_LINES["rope_elite"], launches=glaunches["rope_elite"],
                 max_abs_err=errs["rope_elite"],
                 ms=time_ms(lambda: re_k.rope_elite_qk(*a), flush=flush),
                 plain_ms=time_ms(lambda: ref.rope_elite_qk_ref(*a), flush=flush),
                 bound_ms=r_bound, bound_by=r_by, library_ms=None)
        if label == "EliteKV prefill":
            rows.append(r)
        q, k, pos = a[:3]
        print(f"[{card}] rope_elite_qk {label}: q={tuple(q.shape)} stride={q.stride()} "
              f"k={tuple(k.shape)} positions {tuple(pos.shape)} {pos.dtype} "
              f"{re_k.plan_for(*a)}: "
              f"kernel {r['ms']:.4f} ms, two one-tensor launches with the rows "
              f"expanded per call (the callers before the q-and-k entry) "
              f"{time_ms(lambda: rope_two_launches(a), flush=flush):.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r_bound:.6f} ms ({r_by}: {r_bytes} B, "
              f"{r_flops} flop), {100 * r_bound / r['ms']:.1f}% of the bound; launches "
              f"{rope_launches[label.split()[1]]} per generate run", flush=True)
    # the rotation's backward (transpose mode) at the uptraining step's
    # inputs: q's gradient a [8, 512, 32, 16] slice of [..., 64], k's
    # [8, 512, 4, 16]; bound: the gradients read and written once
    a = train3k["bwd_args"]
    b_bytes, b_flops = rope_cost(a)
    b_bound, b_by = bound(b_bytes, b_flops)
    rows.append(dict(
        name="rope_elite_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/rope_elite.cu",
        replaces=TPU_LINES["rope_elite"], launches=train3k["launches"]["rope_elite_backward"],
        max_abs_err=train3k["rope_err"],
        ms=time_ms(lambda: re_k.rope_elite_backward(*a), flush=flush),
        plain_ms=time_ms(lambda: ref.rope_elite_qk_ref(*a, transpose=True), flush=flush),
        bound_ms=b_bound, bound_by=b_by, library_ms=None))
    r = rows[-1]
    print(f"[{card}] rope_elite_qk backward (transpose mode) at the uptraining step's "
          f"gradients: g_q={tuple(a[0].shape)} stride={a[0].stride()} g_k="
          f"{tuple(a[1].shape)} {re_k.plan_for(*a)}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {b_bound:.6f} ms ({b_by}: {b_bytes} B, {b_flops} "
          f"flop), {100 * b_bound / r['ms']:.1f}% of the bound; launches "
          f"{r['launches']} in the {TRAIN_STEPS}-step uptraining run ({NUM_LAYERS} per "
          f"step)", flush=True)
    by = {r["name"]: r for r in rows}
    dec = by["elite_decode"]
    print(f"[{card}] target elite_decode faster than SDPA: {dec['ms']:.4f} vs "
          f"{dec['library_ms']:.4f} ms ({'met' if dec['ms'] < dec['library_ms'] else 'missed'}"
          f"; aim <= 0.05 ms); elite_verify_paged <= 0.10 ms: "
          f"{by['elite_verify_paged']['ms']:.4f} ms", flush=True)
    for name, was in EARLIER_MS.items():
        print(f"[{card}] {name}: {by[name]['ms']:.4f} ms against {was} ms before the "
              f"split-KV body (ratio {by[name]['ms'] / was:.3f})", flush=True)
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms (SDPA)"
        print(f"[{card}] {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}, "
              f"launches {r['launches']}")

    # the int8 sparse run's busiest step against dense decode over the same
    # lanes: what --pool-dtype int8 and --sparse-topk buy the decode kernel
    name = "elite_decode_sparse_paged_q8"
    a, i = busiest[name]
    q_e, q_lat, pages, scales, _, _, _, G, bs = split_decode(name, a)
    sel_args = recs[name].calls["select_topk_blocks"][i]
    chain = (sel_args[3], sel_args[4])                       # block_tables, lengths
    k32, c32, _ = ref.dequantize_pages(*pages, *scales)
    variants = {
        "dense f32": ("elite_decode_paged", (q_e, q_lat, k32, c32, c32, *chain, G, a[-2], bs)),
        "dense int8": ("elite_decode_paged_q8", (q_e, q_lat, *pages, *scales, *chain,
                                                 G, a[-2], bs)),
        "sparse int8": (name, a)}
    ms = {k: time_ms(lambda: run_decode(n, v), flush=flush) for k, (n, v) in variants.items()}
    rows_f32 = int(chain[1].sum())
    bpt_f32 = runs["elite_decode_paged"][0].pool_bytes_per_token
    bpt_q8 = runs[name][0].pool_bytes_per_token
    print(f"[{card}] decode step, int8 + sparse k=4+2 busiest step ({q_e.shape[0]} lanes, "
          f"{rows_f32} live rows, {visited_rows(name, a)} selected): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; pool bytes/token f32 {bpt_f32} vs int8 + summaries {bpt_q8}"
          f" (int8 dense run: {runs['elite_decode_paged_q8'][0].pool_bytes_per_token})",
          flush=True)
    # the busiest verify step against scoring its window one token at a
    # time: five decode calls at lengths q_offsets + 1 ... + 5, same lanes
    name = "elite_verify_paged"
    a = busiest[name][0]
    q_e, q_lat, pages, _, table, offs, lens, G, bs = split_decode(name, a)
    W = q_e.shape[1]
    live = lens > 0
    steps = [(q_e[:, w].contiguous(), q_lat[:, w].contiguous(), *pages, table,
              torch.where(live, torch.minimum(offs + w + 1, lens), 0).int(), G, a[-2], bs)
             for w in range(W)]
    t_verify = time_ms(lambda: run_decode(name, a), flush=flush)
    t_decodes = time_ms(lambda: [run_decode("elite_decode_paged", d) for d in steps],
                        flush=flush)
    print(f"[{card}] verify W={W} over {int(live.sum())} lanes ({visited_rows(name, a)} "
          f"rows): {t_verify:.4f} ms in one call against {t_decodes:.4f} ms for {W} decode "
          f"calls at lengths q_offsets+1..+{W} ({t_decodes / t_verify:.2f}x)", flush=True)
    for decode, (rep, _) in runs.items():
        print(f"[{card}] serving {decode}: decode tok/s={rep.tok_per_s:.1f} "
              f"ttft_ms p50={rep.ttft_wall_p50_ms:.1f} "
              f"step_ms p50/p95={rep.step_ms_p50:.2f}/{rep.step_ms_p95:.2f} "
              f"wall_s={rep.wall_s:.2f}", flush=True)
    for label, (st, wall) in gen.items():
        dec = np.asarray(st.step_ms[1:])
        print(f"[{card}] serving generate {label}: decode tok/s="
              f"{st.decoded_tokens / wall:.1f} prefill_ms={st.step_ms[0]:.2f} "
              f"step_ms p50/p95={np.percentile(dec, 50):.2f}/{np.percentile(dec, 95):.2f} "
              f"cache_MiB={st.cache_bytes / 2**20:.2f} wall_s={wall:.2f}", flush=True)
    for label, rep in spec_runs.items():
        print(f"[{card}] serving {label}: tok/s={rep.tok_per_s:.1f} "
              f"step_ms p50={rep.step_ms_p50:.2f} acceptance={rep.acceptance_rate:.3f} "
              f"tokens/forward={rep.tokens_per_forward:.2f} "
              f"forwards={rep.draft_forwards} draft + {rep.decode_steps} "
              f"{'verify' if rep.speculate_k else 'decode'} wall_s={rep.wall_s:.2f}",
              flush=True)

    # phase 3g's numbers: the sampler's cost, the prefix cache, host swap
    g, sm = feats["greedy"], feats["sampled"]
    print(f"[{card}] sampler: sample_tokens on [{base['max_slots']}, {cfg.vocab_size}] "
          f"{feats['sampler ms']:.4f} ms per call as the loop issues it, argmax "
          f"{feats['argmax ms']:.4f} ms; decode step_ms p50/p95 sampled "
          f"{sm.step_ms_p50:.2f}/{sm.step_ms_p95:.2f} vs greedy {g.step_ms_p50:.2f}/"
          f"{g.step_ms_p95:.2f} (same 12 requests), tok/s {sm.tok_per_s:.1f} vs "
          f"{g.tok_per_s:.1f}, sample phase {sm.phase_ms['sample']:.1f} vs "
          f"{g.phase_ms['sample']:.1f} ms", flush=True)
    for ev in ("recompute", "swap"):
        r = feats[f"tight {ev}"]
        print(f"[{card}] sampled tight pool {ev}: preemptions={r.preemptions} swaps out/in="
              f"{r.swap_outs}/{r.swap_ins} swapped_bytes={r.swapped_bytes} swap phase "
              f"{r.phase_ms['swap']:.1f} ms, prefill forward tokens "
              f"{r.prefill_forward_tokens}, tok/s={r.tok_per_s:.1f}, streams parted "
              f"{feats[f'cmp {ev}']['parted']}", flush=True)
    r = feats["spec"]
    print(f"[{card}] sampled spec k=4 r=full: acceptance={r.acceptance_rate:.4f} "
          f"tokens/forward={r.tokens_per_forward:.2f} tok/s={r.tok_per_s:.1f} step_ms p50="
          f"{r.step_ms_p50:.2f} accept phase {r.phase_ms['accept']:.1f} ms, streams parted "
          f"{feats['cmp spec']['parted']}", flush=True)
    for label in ("prefix off", "prefix on"):
        r = feats[label]
        print(f"[{card}] {label}: ttft_ms p50/p95={r.ttft_wall_p50_ms:.1f}/"
              f"{r.ttft_wall_p95_ms:.1f} tok/s={r.tok_per_s:.1f} prefill forward tokens "
              f"{r.prefill_forward_tokens} hit_rate={r.prefix_cache_hit_rate:.3f} hit tokens "
              f"{r.prefix_cache_hit_tokens} cow={r.cow_copies} prefill phase "
              f"{r.phase_ms['prefill']:.1f} ms wall_s={r.wall_s:.2f}", flush=True)
    r = feats["int8 swap"]
    print(f"[{card}] int8 + sparse swap tight pool: preemptions={r.preemptions} swaps out/in="
          f"{r.swap_outs}/{r.swap_ins} swapped_bytes={r.swapped_bytes} swap phase "
          f"{r.phase_ms['swap']:.1f} ms tok/s={r.tok_per_s:.1f}", flush=True)
    for dtype in ("float32", "int8"):
        nbytes, t_out, t_in = feats[f"swap {dtype}"]
        print(f"[{card}] swap of one 1024-token sequence, {dtype} pool: {nbytes} B, out "
              f"{t_out:.3f} ms ({nbytes / t_out / 1e6:.2f} GB/s), in {t_in:.3f} ms "
              f"({nbytes / t_in / 1e6:.2f} GB/s), host clock, median of 5", flush=True)

    # phase 3l's numbers
    q, jb, fm = hyb["qwen"], hyb["jamba"], hyb["falcon"]
    r = q["rep"]
    print(f"[{card}] 3l Qwen3-MoE {QWEN_LAYERS} layer(s), Scheduler f32 24 requests: "
          f"decode tok/s="
          f"{r.tok_per_s:.1f} ttft_ms p50/p95={r.ttft_wall_p50_ms:.1f}/{r.ttft_wall_p95_ms:.1f} "
          f"step_ms p50/p95={r.step_ms_p50:.2f}/{r.step_ms_p95:.2f} wall_s={r.wall_s:.2f}, "
          f"peak memory {q['peak'] / 2**30:.2f} GiB ({hyb['held'] / 2**30:.2f} held "
          f"before), pool {r.pool_bytes_per_token} B per "
          f"token (attention), SSM 0 B, group-size syncs {q['syncs']:.1f} per forward; "
          f"profile: {q['profile']['wall_ms']:.2f} ms per decode step, "
          f"{q['profile']['events']:.0f} device events and {q['profile']['syncs']:.1f} "
          f"syncs per step, device busy {q['profile']['busy_ms']:.2f} ms per step",
          flush=True)
    for label, x in (("Jamba period", jb), (f"Falcon-Mamba {FALCON_GEN_LAYERS} layers", fm)):
        st = x["stats"]
        dec = np.asarray(st.step_ms[1:])
        prof = x.get("profile")
        print(f"[{card}] 3l {label}, generate 8 x (1024 + 128): decode tok/s="
              f"{st.decoded_tokens / x['wall']:.1f} prefill_ms={st.step_ms[0]:.2f} step_ms "
              f"p50/p95={np.percentile(dec, 50):.2f}/{np.percentile(dec, 95):.2f} "
              f"wall_s={x['wall']:.2f}, peak memory {x['peak'] / 2**30:.2f} GiB "
              f"({hyb['held'] / 2**30:.2f} held before), attention "
              f"cache {st.cache_bytes} B, SSM state {st.ssm_bytes} B"
              + (f", group-size syncs {x['syncs']:.1f} per decode step; profile: "
                 f"{prof['wall_ms']:.2f} ms per decode step, {prof['events']:.0f} device "
                 f"events and {prof['syncs']:.1f} syncs per step, device busy "
                 f"{prof['busy_ms']:.2f} ms per step" if prof else ""), flush=True)
    for r in hyb["subrows"]:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[{card}] 3l {r['name']} at {r['at']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"SDPA {lib}, launches {r['launches']}", flush=True)

    # phase 3m's numbers
    for label, key, n in (("InternVL2-2B", "internvl", FRONT_TRAIN_STEPS),
                          ("MusicGen-large", "musicgen", 1)):
        x = fronts[key]
        tr = x["train"]
        print(f"[{card}] 3m {label}: search {x['search']:.2f} s, SVDs and surgery "
              f"{x['convert']:.2f} s; paged prefill + decode {x['paged_wall']:.3f} s, rows "
              f"within {x['paged_d']:.3e} of apply_train; {n} training step(s): losses "
              + " ".join(f"{v:.4f}" for v in tr["losses"]) + ", step ms "
              + " ".join(f"{t:.1f}" for t in tr["step_ms"])
              + f", peak memory {tr['peak'] / 2**30:.2f} GiB ({fronts['held'] / 2**30:.2f} "
              f"held before)", flush=True)
    r = fronts["internvl"]["rep"]
    print(f"[{card}] 3m InternVL2-2B Scheduler f32 8 text requests: decode tok/s="
          f"{r.tok_per_s:.1f} ttft_ms p50/p95={r.ttft_wall_p50_ms:.1f}/{r.ttft_wall_p95_ms:.1f} "
          f"step_ms p50/p95={r.step_ms_p50:.2f}/{r.step_ms_p95:.2f} wall_s={r.wall_s:.2f}, pool "
          f"{r.pool_bytes_per_token} B per token", flush=True)
    for r in fronts["subrows"]:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[{card}] 3m {r['name']} at {r['at']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"SDPA {lib}, launches {r['launches']}", flush=True)

    # phase 3n's numbers
    a, b, c, d = tr3n["qwen1"], tr3n["qwen4"], tr3n["jamba"], tr3n["falcon"]
    print(f"[{card}] 3n a. Qwen3-MoE 1 layer: conversion search {a['search']:.2f} s, SVDs "
          f"and surgery {a['convert']:.2f} s; loss + backward at B 1 x 512: first ragged pass "
          f"{a['first']['fwd_ms']:.1f} + {a['first']['bwd_ms']:.1f} ms, then ragged "
          f"{a['ragged']['fwd_ms']:.1f} + {a['ragged']['bwd_ms']:.1f} ms ({a['ragged']['syncs']} "
          f"group-size syncs per step, peak {a['ragged']['peak'] / 2**30:.2f} GiB), dense "
          f"{a['dense']['fwd_ms']:.1f} + {a['dense']['bwd_ms']:.1f} ms (peak "
          f"{a['dense']['peak'] / 2**30:.2f} GiB); gradients ragged vs dense {a['worst']:.3e} "
          f"of a leaf's largest; a whole AdamW step would hold ~{a['adamw_gb']['f32']:.1f} GB "
          f"(f32 moments) or ~{a['adamw_gb']['int8']:.1f} GB (int8) + "
          f"{a['adamw_gb']['lm_head']:.1f}; wall {a['wall']:.1f} s", flush=True)
    for label, x in ((f"b. converted Qwen3-MoE {QWEN_LAYERS} layer(s), generate 8 x "
                      f"(512 + 32)", b),
                     ("c. converted Jamba period, generate 8 x (1024 + 128)", c)):
        st, g = x["gen"]["stats"], x["gen"]
        dec = np.asarray(st.step_ms[1:])
        print(f"[{card}] 3n {label}: search {x['search']:.2f} s, SVDs and surgery "
              f"{x['convert']:.2f} s; decode tok/s={st.decoded_tokens / g['wall']:.1f} "
              f"prefill_ms={st.step_ms[0]:.2f} step_ms p50/p95={np.percentile(dec, 50):.2f}/"
              f"{np.percentile(dec, 95):.2f}; rows within {g['max_d']:.3e} of apply_train "
              f"({g['excused']} excused by routing); peak {x['peak'] / 2**30:.2f} GiB; wall "
              f"{x['wall']:.1f} s", flush=True)
    t = c["train"]
    print(f"[{card}] 3n c. converted Jamba layers 0-3, loss + backward at B 1 x 512: "
          f"first pass {c['first']['fwd_ms']:.1f} + {c['first']['bwd_ms']:.1f} ms, then "
          f"{t['fwd_ms']:.1f} + {t['bwd_ms']:.1f} ms, {t['syncs']} group-size syncs per step, "
          f"peak {t['peak'] / 2**30:.2f} GiB", flush=True)
    print(f"[{card}] 3n d. Falcon-Mamba-7B 8 layers: AdamW step p50 {d['p50']:.1f} ms, "
          f"{d['tok_s']:.0f} tokens/s, peak {d['peak'] / 2**30:.2f} GiB, losses "
          f"{d['losses'][0]:.4f} -> {d['losses'][-1]:.4f}; one layer's loss + backward peak "
          f"above what was held {d['recompute_peak'] / 2**30:.2f} GiB with the per-chunk "
          f"recompute against {d['unroll_peak'] / 2**30:.2f} GiB unrolled "
          f"({d['recompute_ms']:.1f} against {d['unroll_ms']:.1f} ms); wall {d['wall']:.1f} s",
          flush=True)
    for arch, x in tr3n["steps"].items():
        print(f"[{card}] 3n e. reduced {arch}, one train step card vs CPU: worst "
              f"{x['worst']:.3e} of a leaf's largest, {x['flips']} weights of gradient under "
              f"{BIG_GRAD} within 2·lr (both steps {tr3n['steps_wall']:.1f} s)", flush=True)
    for r in tr3n["subrows"]:
        print(f"[{card}] 3n {r['name']} at {r['at']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
              f"launches {r['launches']}", flush=True)

    # phase 3p's numbers
    for name, x in dp3p["scenarios"].items():
        agree = x.get("rows")
        print(f"[{card}] 3p {name}: dp=2 tok/s {x['tok_s']:.1f} against one Scheduler's "
              f"{x['single_tok_s']:.1f}; TTFT p50/p95 {x['ttft'][0]:.1f}/{x['ttft'][1]:.1f} "
              f"against {x['single_ttft'][0]:.1f}/{x['single_ttft'][1]:.1f} ms; replica step "
              f"p50 {x['step_p50'][0]:.2f}/{x['step_p50'][1]:.2f} against "
              f"{x['single_step_p50']:.2f} ms; near-ties {x['ties']}"
              + (f"; rows bitwise equal {agree['bitwise']}/{agree['rows']}, max |d| "
                 f"{agree['max_d']:.3e}" if agree else ""), flush=True)

    # phase 3q's numbers
    for (kind, tp), x in tp3q["runs"].items():
        print(f"[{card}] 3q {kind} tp={tp}: bytes_per_token_per_device {x['bpt_dev']} "
              f"(global {x['bpt']}), decode step p50 {x['step_p50']:.3f} ms, launches "
              f"{x['launches']}", flush=True)
    for r in tp3q["rows"]:
        print(f"[{card}] 3q row 1t elite_decode_paged tp={r['tp']} shard (nkv {r['nkv']}): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), launches {r['launches']}, max_abs_err "
              f"{r['max_abs_err']:.3e}", flush=True)

    # phase 3r's numbers, beside 3p's tp 1 (one Scheduler, or the dp=2 router)
    for (name, tp), x in tp3r["runs"].items():
        one = dp3p["scenarios"][name]
        if tp == "2x2":
            print(f"[{card}] 3r {name} tp=2 dp=2: tok/s {x['tok_s']:.1f} against "
                  f"{one['tok_s']:.1f} at tp 1; TTFT p50/p95 {x['ttft'][0]:.1f}/"
                  f"{x['ttft'][1]:.1f} against {one['ttft'][0]:.1f}/{one['ttft'][1]:.1f} ms; "
                  f"replica step p50 {x['step_p50'][0]:.2f}/{x['step_p50'][1]:.2f} against "
                  f"{one['step_p50'][0]:.2f}/{one['step_p50'][1]:.2f} ms; pool bytes per "
                  f"token per device {x['bpt_dev']}", flush=True)
            continue
        print(f"[{card}] 3r {name} tp={tp}: tok/s {x['tok_s']:.1f} against "
              f"{one['single_tok_s']:.1f} at tp 1; TTFT p50/p95 {x['ttft'][0]:.1f}/"
              f"{x['ttft'][1]:.1f} against {one['single_ttft'][0]:.1f}/"
              f"{one['single_ttft'][1]:.1f} ms; step p50 {x['step_p50']:.2f} against "
              f"{one['single_step_p50']:.2f} ms; pool bytes per token per device "
              f"{x['bpt_dev']} against {x['one_bpt_dev']}", flush=True)

    # -- 5. result lines -----------------------------------------------------
    t = train3k
    print(f"[{card}] uptraining (3k): step_ms p50 {t['step_ms_p50']:.1f}, tokens/s "
          f"{t['tok_s']:.0f}, peak memory {t['peak_bytes'] / 2**30:.2f} GiB, model-FLOP share "
          f"{100 * t['mfu']:.1f}% of 67 TFLOP/s, losses {t['losses'][0]:.4f} -> "
          f"{t['losses'][-1]:.4f}", flush=True)
    print(f"[{card}] phases 3i (conversion) {conv['phase']:.1f} s, 3k (training) "
          f"{t['phase']:.1f} s, 3j (MiniCPM-2B) {tied['wall']:.1f} s, 3l (MoE, Mamba, "
          f"hybrid) {hyb['wall']:.1f} s, 3m (frontends) {fronts['wall']:.1f} s and 3n (MoE, "
          f"Mamba and hybrid training and conversion) {tr3n['wall']:.1f} s, 3o (the dry run "
          f"against the card) {dry['wall']:.1f} s, 3p (the data-parallel router) "
          f"{dp3p['wall']:.1f} s, 3q (tensor-parallel attention) {tp3q['wall']:.1f} s, 3r "
          f"(tensor-parallel serving) {tp3r['wall']:.1f} s, 3s (the sharded steps) "
          f"{sh3s['wall']:.1f} s; "
          f"the whole script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    rows.append(sh3s["merge"]["row"])
    if not (isinstance(rows, list) and rows and all(isinstance(r, dict) for r in rows)):
        raise AssertionError(f"the kernel rows are {rows!r}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
