"""Serve a batch in lockstep over a contiguous cache, or a Poisson request
stream through the paged EliteKV scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --elitekv --batch 8 --prompt-len 1024 --new-tokens 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --elitekv --stream --requests 16 --rate 0.5 --max-slots 4 \\
        --block-size 16 --num-blocks 128

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead (``--reduced`` shrinks the model for that).
Weights are random, from ``--seed``.  ``--arch`` takes the dense
architectures, the MoE stacks ``qwen3_moe_235b`` and ``arctic_480b``, the
attention/Mamba hybrid ``jamba_v0_1_52b``, the pure Mamba
``falcon_mamba_7b`` and the vision model ``internvl2_2b``, which serves text
prompts (no patches) in both modes; ``--elitekv`` compresses the attention
layers and is ignored for a stack without any.  The audio model
``musicgen_large`` takes frame embeddings, not token prompts, and is
refused with ``ValueError`` (``models/lm.py``'s entry points serve it).  ``--stream`` needs an attention-only
stack: a stack with Mamba layers serves in batch mode only:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_235b \
        --reduced --elitekv --stream --device cpu --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b \
        --reduced --elitekv --device cpu --batch 2 --prompt-len 12 --new-tokens 6

Without ``--stream`` (batch mode) ``generate`` decodes ``--batch`` random
prompts of ``--prompt-len`` tokens greedily for ``--new-tokens`` steps and
prints tok/s, step ms, the cache floats per token against the baseline's
with their ratio, the measured attention cache and the first requests'
tokens.  With ``--elitekv`` it serves the EliteKV model (``--cache-ratio``
picks its dims), without it the baseline GQA model.

``--stream`` (EliteKV only) draws arrivals
(``--rate`` requests per decode step, exponential inter-arrivals), prompt
lengths and generation budgets from a seeded generator — the same stream
the JAX driver draws — and the ``Scheduler`` admits, prefills (whole, or
``--prefill-chunk`` tokens for up to ``--prefill-lanes`` lanes per forward),
decodes and retires them.  ``--temperature`` / ``--top-p`` select nucleus
sampling (temperature 0 = greedy); request ``i`` samples with the PRNG seed
``--sample-seed + i``, so reruns reproduce token for token, preemptions
included.  ``--prefix-cache`` shares full prompt blocks across requests
(content-addressed, copy-on-write); ``--shared-prefix N`` puts one common
N-token prefix, drawn from ``--seed``, before every prompt so the cache
has something to hit.  ``--eviction swap`` makes a preemption copy the
victim's cached streams to pinned host memory and restore them on
re-admission, instead of recomputing them.  The run ends with the scheduler
metrics line (throughput, TTFT, step latency, pool reuse, preemptions and
swaps), the prefix cache's hit rate and copies, the pool accounting and the
per-phase wall breakdown:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --temperature 0.8 --top-p 0.9 --sample-seed 7
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --prefix-cache --shared-prefix 32 --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --eviction swap --num-blocks 24 --block-size 4

``--pool-dtype int8`` stores the pool as int8 rows with per-slot f32 scales;
``--sparse-topk K`` decodes over the K best-scoring blocks plus the
``--sparse-recent`` newest ones.  Below full width, sparse decode with
preempt admission needs ``--eviction swap`` (a recompute after preemption
would re-prefill densely and fork the stream), or ``--admission
watermark``:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --pool-dtype int8 --sparse-topk 2 \
        --eviction swap

``--speculate K`` decodes by self-speculative macro-steps: ``K`` draft
forwards (``--draft-rank R`` truncates the draft's joint factors to rank R;
0 = the full model) and one verify forward per step; sampled requests
accept by rejection sampling.  It cannot be combined with
``--sparse-topk``:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --speculate 2 --draft-rank 16

Observability: ``--trace out.json`` records the stream run into a
ring-buffer tracer (``--trace-capacity`` events, the oldest dropped beyond)
and writes a Chrome trace-event timeline — open it in
https://ui.perfetto.dev — with the scheduler's phase spans, request
lifecycles per slot, pool events and counters, and a span per kernel launch
on the ``kernel`` track (timed by CUDA events on the card, read when the
trace is written).  ``--metrics-out metrics.prom`` writes the process-wide
metrics registry in Prometheus text format.  Traced and untraced streams
are token-identical.  Check and summarise the artifacts with

    python tools/check_trace.py out.json --metrics metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.diagnose trace-summary out.json

Batch mode rejects both flags, as the reference does.

``--tp N`` (with ``--stream``) serves tensor-parallel: the attention heads
and the pool's ``k_e`` pages are split over ``N`` devices
(``Scheduler(mesh=)``); the streams equal ``--tp 1``'s, and the run adds a
``pool/device:`` line (pool bytes per token on each device, the global
figure and tp).  ``N`` must divide the model's kv heads (an argument error
otherwise).  ``--dp M`` (with ``--stream``) serves the stream through ``M``
independent ``Scheduler`` replicas behind the least-loaded router
(``runtime/router.py``), each with its own pool of ``--num-blocks``
blocks; the merged token streams equal one scheduler's.  Placement
follows ``--device`` (``launch/mesh.py::replica_meshes``): a bare
``cuda`` puts replica ``i``'s shard ``j`` on card ``i·N + j`` and needs
``N·M`` cards, while ``cuda:0`` or ``cpu`` hosts every shard of every
replica on that one device.  A router run prints the ``stream [tp= dp=
devices=]`` summary line, one line per replica and the ``pool/device:``
line; ``--trace`` puts each replica's events on ``r{i}:`` tracks beside
the router's ``route`` instants (each shard's kernel launch is one span on
the ``kernel`` track), and ``--metrics-out`` adds the
``serve_replica_{i}_*`` family:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --elitekv \
        --stream --device cpu --tp 2 --dp 2 --trace out.json --metrics-out m.prom

``--tp``/``--dp`` below 1, or above 1 without ``--stream``, are argument
errors, as in the reference.  ``--moe-impl``
picks how MoE layers dispatch in every forward of either mode: "ragged"
(the default) or the "dense" oracle; "ep" (expert parallelism, ROADMAP
item 15d) raises ``ValueError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cache import model_cache_floats_per_token
from repro_torch.core.convert import pick_dims
from repro_torch.kernels import ops
from repro_torch.launch.mesh import replica_meshes
from repro_torch.models import lm, moe
from repro_torch.obs import REGISTRY, Tracer, write_chrome_trace
from repro_torch.runtime import serve_loop
from repro_torch.runtime.router import Router


def make_stream(cfg, n_requests: int, rate: float, prompt_len: int,
                new_tokens: int, seed: int, prompt_min: int = 4,
                new_min: int = 4, shared_prefix: int = 0, temperature: float = 0.0,
                top_p: float = 1.0, sample_seed: int = 0):
    """Seeded Poisson stream: prompt lengths uniform in [prompt_min,
    prompt_len], budgets uniform in [new_min, new_tokens], drawn in the JAX
    driver's order.  ``shared_prefix > 0`` draws one prefix of that many
    tokens first and puts it before every prompt.  Request ``i`` samples
    with ``temperature``/``top_p`` and seed ``sample_seed + i``."""
    rng = np.random.default_rng(seed)
    p_lo, n_lo = min(prompt_min, prompt_len), min(new_min, new_tokens)
    shared = (rng.integers(0, cfg.vocab_size, shared_prefix).astype(np.int32)
              if shared_prefix else None)
    t, reqs = 0.0, []
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(p_lo, prompt_len + 1))).astype(np.int32)
        if shared is not None:
            prompt = np.concatenate([shared, prompt])
        reqs.append(serve_loop.Request(
            uid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(n_lo, new_tokens + 1)), arrival=t,
            temperature=temperature, top_p=top_p, seed=sample_seed + i))
    return reqs


def serve_stream(params, buffers, cfg, args):
    scfg = serve_loop.SchedulerConfig(
        max_slots=args.max_slots, block_size=args.block_size,
        num_blocks=args.num_blocks, eos_id=args.eos_id,
        max_new_tokens=args.new_tokens,
        max_len=args.shared_prefix + args.prompt_len + args.new_tokens + 1,
        prefill_chunk_tokens=args.prefill_chunk,
        prefill_batch_lanes=args.prefill_lanes, admission=args.admission,
        eviction=args.eviction, prefix_cache=args.prefix_cache,
        cache_dtype="int8" if args.pool_dtype == "int8" else "float32",
        sparse_topk_blocks=args.sparse_topk, sparse_recent_blocks=args.sparse_recent,
        speculate_k=args.speculate, draft_rank=args.draft_rank)
    tracer = Tracer(capacity=args.trace_capacity) if args.trace else None
    reqs = make_stream(cfg, args.requests, args.rate, args.prompt_len,
                       args.new_tokens, args.seed, shared_prefix=args.shared_prefix,
                       temperature=args.temperature, top_p=args.top_p,
                       sample_seed=args.sample_seed)
    meshes = replica_meshes(tp=args.tp, dp=args.dp, device=args.device)
    if args.dp > 1:
        return serve_routed(params, buffers, cfg, scfg, reqs, tracer, meshes, args)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, tracer=tracer, metrics=REGISTRY,
                                 moe_impl=args.moe_impl, mesh=meshes[0])
    ops.set_kernel_tracer(tracer, device=list(meshes[0].devices))
    try:
        report = sched.run(reqs)
    finally:
        ops.set_kernel_tracer(None)
    stats = sched.pool.stats()
    if args.tp == 1:
        print(f"arch={cfg.name} stream [{args.device}]: {report.summary()}")
    else:
        print(f"arch={cfg.name} stream [tp={args.tp}]: {report.summary()}")
        print(pool_device_line(sched.pool))
    if scfg.prefill_chunk_tokens:
        print(f"chunked prefill: {report.prefill_chunks} forwards of "
              f"<= {scfg.prefill_chunk_tokens} tokens x {scfg.chunk_lanes} "
              f"lanes (mean {report.mean_prefill_batch:.2f} live) "
              f"interleaved with decode")
    if scfg.speculate_k:
        print(f"speculative decode [k={scfg.speculate_k} "
              f"rank={scfg.draft_rank or 'full'}]: "
              f"accepted {report.draft_accepted}/{report.draft_proposed} "
              f"draft tokens (rate {report.acceptance_rate:.2f}, "
              f"mean {report.mean_accepted:.2f}/window) over "
              f"{report.draft_forwards} draft + {report.decode_steps} verify "
              f"forwards -> {report.tokens_per_forward:.2f} tokens/forward")
    if scfg.sparse_topk_blocks:
        print(f"sparse decode [topk={report.sparse_topk} "
              f"recent={report.sparse_recent}]: "
              f"mean {report.mean_selected_blocks:.1f}/"
              f"{report.mean_candidate_blocks:.1f} blocks attended per lane "
              f"over {report.sparse_steps} decode forwards")
    if scfg.prefix_cache:
        print(f"prefix cache: hit_rate={report.prefix_cache_hit_rate:.2f} "
              f"({report.prefix_cache_hit_tokens} prompt tokens served from "
              f"cache across {report.prefix_cache_hits} hits / "
              f"{report.prefix_cache_misses} misses), "
              f"cow_copies={report.cow_copies}, "
              f"retained_blocks={report.blocks_retained}")
    if report.preemptions:
        print(f"preemption [{scfg.eviction}]: {report.preemptions} evictions "
              f"across {report.preempted_requests} requests "
              f"(host swaps out/in {report.swap_outs}/{report.swap_ins}, "
              f"{report.swapped_bytes / 2**10:.1f}KiB out); "
              f"mean occupancy {report.mean_occupancy:.2f}")
    print(f"pool: block_size={stats.block_size} blocks={stats.num_blocks} "
          f"high_water={report.pool_high_water_blocks} "
          f"free_after_drain={stats.blocks_free} dtype={report.pool_dtype} "
          f"bytes_per_token={report.pool_bytes_per_token} "
          f"allocated_bytes_peak={report.pool_allocated_bytes_peak / 2**20:.2f}MiB")
    if report.block_reuse_ratio > 1.0:
        print(f"block reuse: peak {report.pool_high_water_blocks} blocks served "
              f"a workload whose naive footprint is {report.naive_blocks} "
              f"({report.block_reuse_ratio:.2f}x)")
    print(f"phases: {report.phase_table()} "
          f"(step wall {report.step_wall_ms_total:.0f}ms)")
    write_observability(tracer, args)
    return report


def write_observability(tracer, args) -> None:
    """Write the trace and the metrics registry where the flags ask."""
    if tracer is not None:
        path = write_chrome_trace(args.trace, tracer)
        print(f"trace: {tracer.emitted} events "
              f"({tracer.dropped} dropped by the ring) -> {path} "
              f"(open in https://ui.perfetto.dev)")
    if args.metrics_out:
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            f.write(REGISTRY.to_prometheus())
        print(f"metrics: {len(REGISTRY.names())} instruments -> "
              f"{args.metrics_out} (Prometheus text format)")


def pool_device_line(pool) -> str:
    """The reference's per-device pool line: bytes per token on each device
    of the mesh, beside the global figure."""
    return (f"pool/device: {pool.bytes_per_token_per_device()}B/token "
            f"(global {pool.bytes_per_token()}B/token, tp={pool.tp})")


def serve_routed(params, buffers, cfg, scfg, reqs, tracer, meshes, args):
    """``--dp N``: the stream through ``N`` Scheduler replicas behind the
    router, one ``TPMesh`` each (``launch/mesh.py::replica_meshes``)."""
    router = Router(params, buffers, cfg, scfg, num_replicas=args.dp, meshes=meshes,
                    moe_impl=args.moe_impl, tracer=tracer, metrics=REGISTRY)
    devices = router.shard_devices()
    ops.set_kernel_tracer(tracer, device=devices)
    try:
        rep = router.run(reqs)
    finally:
        ops.set_kernel_tracer(None)
    print(f"arch={cfg.name} stream [tp={args.tp} dp={args.dp} "
          f"devices={','.join(map(str, devices))}]: {rep.summary()}")
    print(rep.per_replica_table())
    print(f"{pool_device_line(router.replicas[0].pool)}; {args.dp} replicas x "
          f"{scfg.num_blocks} blocks x {scfg.block_size} tokens")
    write_observability(tracer, args)
    return rep


def serve_batch(params, buffers, cfg, base, args):
    """Lockstep ``generate`` over random prompts; prints the reference
    driver's lines.  ``base`` is the baseline config of the same arch."""
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out, stats = serve_loop.generate(params, buffers, cfg, prompts, args.new_tokens,
                                     device=args.device, moe_impl=args.moe_impl)
    dt = time.perf_counter() - t0
    base_floats = model_cache_floats_per_token(base)
    elite_floats = model_cache_floats_per_token(cfg)
    decode_ms = np.asarray(stats.step_ms[1:] or [0.0])
    print(f"arch={cfg.name} elitekv={cfg.elitekv.enabled} [{args.device}]")
    print(f"generated {out.shape} in {dt:.1f}s "
          f"({stats.decoded_tokens / max(dt, 1e-9):.1f} tok/s incl. build); "
          f"prefill {stats.step_ms[0]:.1f} ms, decode step ms p50/p95 "
          f"{np.percentile(decode_ms, 50):.2f}/{np.percentile(decode_ms, 95):.2f}")
    print(f"cache floats/token: {elite_floats} vs baseline {base_floats} "
          f"→ ratio {elite_floats / max(base_floats, 1):.3f}")
    print(f"measured attention cache: {stats.cache_bytes / 2**20:.2f} MiB"
          + (f", Mamba state {stats.ssm_bytes / 2**20:.2f} MiB" if stats.ssm_bytes else ""))
    for b in range(min(2, args.batch)):
        print(f"  req{b}: {out[b, :16].tolist()} ...")
    return out, stats


def build_config(arch: str, reduced: bool, cache_ratio: float, elitekv: bool = True):
    """The arch's config (``reduced`` for the CPU), with EliteKV dims picked
    for ``cache_ratio`` unless ``elitekv`` is False (the baseline) or the
    stack has no attention layer."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if not elitekv or not cfg.n_attn_layers:
        return cfg
    return dataclasses.replace(cfg, elitekv=pick_dims(cfg, cache_ratio, align=16))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--elitekv", action="store_true")
    ap.add_argument("--cache-ratio", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch mode: prompts decoded in lockstep")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="Poisson request stream through the paged scheduler")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per decode step")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="per-lane per-step chunked-prefill token budget "
                         "(0 = whole prompt at admission)")
    ap.add_argument("--prefill-lanes", type=int, default=0,
                    help="mid-prefill sequences packed per chunked-prefill "
                         "forward (0 = max-slots)")
    ap.add_argument("--admission", choices=("preempt", "watermark"),
                    default="preempt",
                    help="preempt: admit on demand, evict youngest on "
                         "OutOfBlocks; watermark: legacy worst-case "
                         "reservation (never preempts)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix blocks across requests "
                         "(content-addressed cache, copy-on-write)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common N-token system prefix to every "
                         "stream prompt (exercises --prefix-cache hits)")
    ap.add_argument("--eviction", choices=("recompute", "swap"),
                    default="recompute",
                    help="preemption mechanism: recompute the evicted prefix "
                         "or swap the cached streams to host memory")
    ap.add_argument("--pool-dtype", choices=("f32", "int8"), default="f32",
                    help="pool page type: int8 rows with per-slot f32 scales")
    ap.add_argument("--sparse-topk", type=int, default=0,
                    help="decode over the K best-scoring blocks per lane plus "
                         "--sparse-recent newest blocks (0 = dense)")
    ap.add_argument("--sparse-recent", type=int, default=2,
                    help="newest blocks always attended under --sparse-topk")
    ap.add_argument("--speculate", type=int, default=0,
                    help="self-speculative decode: draft tokens per lane per "
                         "step (0 = plain one-token decode)")
    ap.add_argument("--draft-rank", type=int, default=0,
                    help="joint-factor rank of the draft model (0 or >= "
                         "d_ckv = the full model, acceptance 1)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for stream requests (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1 = full softmax)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base PRNG seed; request i samples with seed+i")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event timeline of the stream "
                         "run to this path (view at ui.perfetto.dev)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="tracer ring-buffer capacity (oldest events drop "
                         "beyond this)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry in Prometheus text "
                         "format to this path after the run")
    ap.add_argument("--moe-impl", choices=("ragged", "dense", "ep"), default="ragged",
                    help="MoE dispatch: ragged (sorted groups) or the dense "
                         "oracle; ep is not ported (ValueError)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width: shard the attention heads and "
                         "the k_e pool pages over N devices (token streams stay "
                         "bit-identical; N must divide the kv heads)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas: N independent schedulers "
                         "behind a least-loaded router (a bare --device cuda "
                         "needs tp x dp cards; cuda:0 or cpu hosts them all)")
    args = ap.parse_args(argv)
    moe.check_impl(args.moe_impl)
    if args.tp < 1 or args.dp < 1:
        ap.error("--tp and --dp must be >= 1")
    if (args.tp > 1 or args.dp > 1) and not args.stream:
        ap.error("--tp/--dp shard the paged serving path; add --stream")
    cfg = build_config(args.arch, args.reduced, args.cache_ratio, args.elitekv)
    if args.tp > 1 and cfg.n_kv_heads % args.tp:
        ap.error(f"--tp {args.tp} must divide n_kv_heads={cfg.n_kv_heads} "
                 "(see pad_cfg_for_tp in distributed/sharding.py)")
    if args.tp > 1 or args.dp > 1:
        replica_meshes(tp=args.tp, dp=args.dp, device=args.device)   # placement errors first
    if get_config(args.arch).frontend == "audio":
        raise ValueError(f"{args.arch} is an audio model with no token embedding: it "
                         "takes frame embeddings through lm's entry points, not the "
                         "token prompts this launcher serves")
    if (args.trace or args.metrics_out) and not args.stream:
        ap.error("--trace/--metrics-out instrument the paged scheduler; "
                 "add --stream")
    if args.trace_capacity < 1:
        ap.error("--trace-capacity must be >= 1")
    if args.stream and not args.elitekv:
        ap.error("--stream requires --elitekv (the paged pool stores the "
                 "compressed streams)")
    if args.stream and get_config(args.arch).ssm_state:
        ap.error(f"--stream needs an attention-only stack; {args.arch} has Mamba "
                 "layers (serve it in batch mode)")
    if not args.stream and min(args.batch, args.prompt_len, args.new_tokens) < 1:
        ap.error("--batch, --prompt-len and --new-tokens must be >= 1")
    if args.rate <= 0:
        ap.error("--rate must be > 0 (mean arrivals per decode step)")
    if args.sparse_topk < 0 or args.sparse_recent < 0:
        ap.error("--sparse-topk and --sparse-recent must be >= 0")
    if args.speculate < 0 or args.draft_rank < 0:
        ap.error("--speculate and --draft-rank must be >= 0")
    if args.sparse_topk > 0 and args.speculate > 0:
        ap.error("--sparse-topk and --speculate are mutually exclusive "
                 "(the multi-query verify window has no single selection "
                 "query)")
    if (args.sparse_topk > 0 and args.admission == "preempt"
            and args.eviction == "recompute"):
        ap.error("--sparse-topk with preempt admission needs --eviction swap "
                 "(recompute prefill cannot reproduce sparse-generated "
                 "streams)")
    if args.shared_prefix < 0:
        ap.error("--shared-prefix must be >= 0")
    # the reference is f32 end to end: keep matmuls out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, buffers = lm.init(cfg, seed=args.seed, device=args.device)
    if not args.stream:
        base = build_config(args.arch, args.reduced, args.cache_ratio, elitekv=False)
        return serve_batch(params, buffers, cfg, base, args)
    return serve_stream(params, buffers, cfg, args)


if __name__ == "__main__":
    main()
