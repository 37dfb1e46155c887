#!/usr/bin/env python3
"""On-card check and measurement of the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (the numbers in PERF.md come from an H100) and the CUDA
toolkit's nvcc; imports nothing of JAX.  Phases, any failure of which exits
non-zero:

1. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   what ``-Xptxas -v`` reports (registers, shared memory, spills).
2. Hold each kernel against its plain PyTorch version on the card at
   TinyLlama-1.1B widths and at LLaMA2-7B widths, with empty lanes, partial
   blocks and ragged per-lane offsets and lengths.
3. Serve TinyLlama-1.1B at full width (22 layers, d 2048, EliteKV r=8,
   d_ckv=64) with random weights from a seeded ``torch.Generator`` — not
   the reference's weights, since the card has no JAX: a Poisson stream of
   24 greedy requests through chunked prefill, then a small one-shot run on
   a pool tight enough to preempt.  The main run must launch the decode
   kernel 22 times per decode forward and the prefill kernel 22 times per
   prefill forward; both kernels are re-run on inputs recorded from that
   run and held against their plain versions; a small run on the card must
   give the CPU's tokens.  A torch.profiler window over 10 steady decode
   steps of 8 lanes gives the card's busy share and its time by kernel.
4. Time each kernel at the main path's shapes (CUDA events, warm-up, L2
   flushed before every launch), its plain version, its bound, and the
   PyTorch call that computes the same function where one exists.

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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores (the kernels use plain f32 FMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = 5e-5                   # f32, same math in another summation order
NUM_LAYERS = 22


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def decode_smem_bytes(G, r2, dc, bs, separate) -> int:
    """csrc/elite_decode_paged.cu: q [G, W+1], kc [bs, W+1], cv [bs, dc] if
    separate, s [G, bs], acc [G, dc], m/l/alpha [G] (W = r2 + dc) floats."""
    wp = r2 + dc + 1
    return 4 * (G * wp + bs * wp + separate * bs * dc + G * bs + G * dc + 3 * G)


def flash_smem_bytes(dh: int) -> int:
    """csrc/flash_prefill.cu: Q [64, dh+1], K [32, dh+1], V [32, dh], P [64, 33]."""
    return 4 * (64 * (dh + 1) + 32 * (dh + 1) + 32 * dh + 64 * 33)


def time_ms(fn, iters: int = 30, warmup: int = 3, flush=None) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each timed by its
    own CUDA events after ``flush`` evicts the L2."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def decode_cost(x, G: int):
    """(bytes, flops) the paged decode needs on these inputs: every input
    read once — only the live tokens' k_e and latent rows — and the output
    written once."""
    B, nh, r2 = x["q_e"].shape
    dc = x["c_k"].shape[-1]
    nkv = nh // G
    live = int(x["lengths"].clamp(max=x["bt"].shape[1] * x["bs"]).sum())
    lat = dc if x["c_v"] is x["c_k"] else 2 * dc
    nbytes = 4 * (x["q_e"].numel() + x["q_lat"].numel() + x["bt"].numel() + B
                  + live * (nkv * r2 + lat) + B * nh * dc)
    flops = live * nh * (2 * (r2 + dc) + 2 * dc)
    return nbytes, flops


def prefill_cost(x):
    """(bytes, flops) of flash prefill on these inputs: q and o whole, each
    lane's k/v rows below kv_len once; 4·dh flops per visible pair and head."""
    q, offs, lens = x["q"], x["offs"].tolist(), x["lens"].tolist()
    B, Sq, nh, dh = q.shape
    nkv = x["k"].shape[2]
    Sk = x["k"].shape[1]
    pairs = 0
    for off, kvl in zip(offs, lens):
        for i in range(Sq):
            pairs += max(0, min(i + off + 1, kvl, Sk))
    kv_rows = sum(min(kvl, Sk) for kvl in lens)
    nbytes = 4 * (2 * q.numel() + 2 * kv_rows * nkv * dh + 2 * B)
    return nbytes, pairs * nh * 4 * dh


def bound(nbytes: int, flops: int):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
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


def run_decode(x, G, plain=False):
    from repro_torch.kernels import elite_decode, ref
    fn = ref.elite_decode_paged_ref if plain else elite_decode.elite_decode_paged
    head_dim = x.get("dh", 64)
    return fn(x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"], x["bt"], x["lengths"],
              G, head_dim ** -0.5, x["bs"])


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


def profile_decode(params, buffers, cfg, dev, card: str, steps: int = 10) -> None:
    """Device time by kernel and the card's busy share over ``steps`` steady
    decode steps of 8 lanes (prompts of 512 tokens, prefilled first)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import serve_loop
    scfg = serve_loop.SchedulerConfig(
        max_slots=8, block_size=16, num_blocks=512, max_new_tokens=64,
        max_len=1024, prefill_chunk_tokens=256, prefill_batch_lanes=8)
    rng = np.random.default_rng(2)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=dev)
    for i in range(8):
        sched.submit(serve_loop.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=64))
    for _ in range(3):                  # two 256-token chunks, then decoding
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets): a CPU op's row repeats
    # the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    print(f"[{card}] profile: {steps} decode steps x 8 lanes: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[{card}]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<6d} {key[:90]}")


class Recorder:
    """Wraps the attention dispatch in ``core.elite_attention`` to keep the
    inputs of every layer-0 kernel call of a run (call ``i`` is layer
    ``i % n_layers``), so the kernels can be re-run on real main-path inputs."""

    def __init__(self, n_layers: int):
        from repro_torch.core import elite_attention
        self.ops, self.n = elite_attention.ops, n_layers
        self.orig = (self.ops.elite_decode_paged, self.ops.flash_prefill)
        self.decode, self.prefill, self._calls = [], [], [0, 0]
        self.ops.elite_decode_paged, self.ops.flash_prefill = self._dec, self._pre

    def _dec(self, *a):
        if self._calls[0] % self.n == 0:
            self.decode.append(a)
        self._calls[0] += 1
        return self.orig[0](*a)

    def _pre(self, *a):
        if self._calls[1] % self.n == 0:
            self.prefill.append(a)
        self._calls[1] += 1
        return self.orig[1](*a)

    def close(self):
        self.ops.elite_decode_paged, self.ops.flash_prefill = self.orig


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import build_config, make_stream
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    # all shared memory is dynamic (ptxas reports none): the bytes per CTA
    # from the kernels' layouts, at the widths below
    for wname, (G, r2, dc) in {"tinyllama_1_1b": (8, 16, 64),
                               "llama2_7b": (1, 32, 1024)}.items():
        for sep in (0, 1):
            print(f"  elite_decode_paged smem/CTA {wname} {'S' if sep else 'J'}-LRD: "
                  f"{decode_smem_bytes(G, r2, dc, 16, sep)} B")
    for dh in (64, 128):
        print(f"  flash_prefill smem/CTA dh={dh}: {flash_smem_bytes(dh)} B")

    # -- 2. kernel parity at both model widths ------------------------------
    errs = {"elite_decode_paged": 0.0, "flash_prefill": 0.0}
    widths = {"tinyllama_1_1b": (32, 4, 16, 64, 64), "llama2_7b": (32, 32, 32, 1024, 128)}
    for i, (wname, (nh, nkv, r2, dc, dh)) in enumerate(widths.items()):
        for separate in (False, True):
            x = random_decode(dev, nh, nkv, r2, dc, separate, seed=i)
            x["dh"] = dh
            G = nh // nkv
            got, want = run_decode(x, G), run_decode(x, G, plain=True)
            e = check(f"elite_decode_paged {wname} {'S-LRD' if separate else 'J-LRD'}",
                      max_err(got, want), card)
            if float(got[0].abs().max()) != 0.0 or float(got[-1].abs().max()) != 0.0:
                raise AssertionError("a length-0 lane did not give exact zeros")
            errs["elite_decode_paged"] = max(errs["elite_decode_paged"], e)
        x = random_prefill(dev, nh, nkv, dh, seed=10 + i)
        got = run_prefill(x)
        e = check(f"flash_prefill {wname}", max_err(got, run_prefill(x, plain=True)), card)
        if float(got[-1].abs().max()) != 0.0:
            raise AssertionError("a kv_len = 0 lane did not give exact zeros")
        errs["flash_prefill"] = max(errs["flash_prefill"], e)

    # -- 3. the main path at full width -------------------------------------
    cfg = build_config("tinyllama_1_1b", reduced=False, cache_ratio=0.25)
    e = cfg.elitekv
    assert (cfg.num_layers, cfg.d_model, e.elite_r, e.d_ckv) == (NUM_LAYERS, 2048, 8, 64), cfg
    params, buffers = lm.init(cfg, seed=0, device=dev)
    scfg = serve_loop.SchedulerConfig(
        max_slots=8, block_size=16, num_blocks=8 * 64, max_new_tokens=128,
        max_len=1024, prefill_chunk_tokens=256, prefill_batch_lanes=8)
    reqs = make_stream(cfg, 24, rate=0.5, prompt_len=768, new_tokens=128, seed=0,
                       prompt_min=64, new_min=32)
    rec = Recorder(cfg.num_layers)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=dev)
    ops.reset_launches()
    rep = sched.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launches()
    rec.close()
    print(f"[{card}] main path {cfg.name} 24 requests: {rep.summary()}", flush=True)
    print(f"[{card}] phases: {rep.phase_table()}")
    print(f"launches: {launches} over {rep.decode_steps} decode and "
          f"{rep.prefill_chunks} prefill forwards x {cfg.num_layers} layers")
    if rep.completed != len(reqs):
        raise AssertionError(f"{rep.completed}/{len(reqs)} requests finished")
    for r in sched.finished:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.uid}: bad output {toks[:8]}...")
    if launches["elite_decode_paged"] != rep.decode_steps * cfg.num_layers:
        raise AssertionError("decode kernel launches != decode forwards x layers")
    if not launches["flash_prefill"] == rep.prefill_chunks * cfg.num_layers > 0:
        raise AssertionError("prefill kernel launches != prefill forwards x layers")

    # the kernels again, on the busiest recorded main-path inputs
    dec = max(rec.decode, key=lambda a: int(a[6].sum()))
    xd = dict(q_e=dec[0], q_lat=dec[1], k_e=dec[2], c_k=dec[3], c_v=dec[4], bt=dec[5],
              lengths=dec[6], bs=dec[9], dh=cfg.head_dim)
    G = cfg.q_group
    errs["elite_decode_paged"] = max(errs["elite_decode_paged"], check(
        "elite_decode_paged on main-path pages",
        max_err(run_decode(xd, G), run_decode(xd, G, plain=True)), card))
    pre = max(rec.prefill, key=lambda a: int(a[6].sum()))
    xp = dict(q=pre[0], k=pre[1], v=pre[2], G=pre[3], scale=pre[4], offs=pre[5], lens=pre[6])
    errs["flash_prefill"] = max(errs["flash_prefill"], check(
        "flash_prefill on a main-path chunk",
        max_err(run_prefill(xp), run_prefill(xp, plain=True)), card))

    # a one-shot run on a tight pool must preempt and still finish everything
    tight = serve_loop.SchedulerConfig(max_slots=4, block_size=16, num_blocks=40,
                                       max_new_tokens=96, max_len=384)
    small = make_stream(cfg, 6, rate=4.0, prompt_len=256, new_tokens=96, seed=1,
                        prompt_min=64, new_min=64)
    srep = serve_loop.Scheduler(params, buffers, cfg, tight, device=dev).run(small)
    print(f"[{card}] tight pool one-shot: {srep.summary()}", flush=True)
    if srep.completed != len(small) or srep.preemptions < 1:
        raise AssertionError("the tight-pool run must finish all requests and preempt")
    profile_decode(params, buffers, cfg, dev, card)
    del params, buffers, sched

    # a narrow model on the card gives the CPU's tokens (plain versions there)
    ncfg = build_config("tinyllama_1_1b", reduced=True, cache_ratio=0.25)
    cp, cb = lm.init(ncfg, seed=3, device="cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else \
        [to(v) for v in t] if isinstance(t, list) else t.to(dev)
    nscfg = serve_loop.SchedulerConfig(max_slots=3, block_size=8, num_blocks=64,
                                       max_len=64, prefill_chunk_tokens=16)
    prompts = np.random.default_rng(3).integers(0, ncfg.vocab_size, (3, 24))
    want, _ = serve_loop.generate_paged(cp, cb, ncfg, prompts, 12, nscfg, device="cpu")
    got, _ = serve_loop.generate_paged(to(cp), to(cb), ncfg, prompts, 12, nscfg, device=dev)
    if not np.array_equal(got, want):
        raise AssertionError(f"card tokens {got.tolist()} != CPU tokens {want.tolist()}")
    print("narrow model: card tokens == CPU tokens", flush=True)

    # -- 4. times at the main path's shapes ----------------------------------
    scratch = torch.empty(64 * 2**20 // 4, device=dev)      # > the 50 MB L2
    flush = scratch.zero_
    rows = []
    d_bytes, d_flops = decode_cost(xd, G)
    d_bound, d_by = bound(d_bytes, d_flops)
    rows.append(dict(
        name="elite_decode_paged", route="cuda",
        source="src/repro_torch/kernels/csrc/elite_decode_paged.cu",
        replaces="src/repro/kernels/elite_decode.py:193",
        launches=launches["elite_decode_paged"], max_abs_err=errs["elite_decode_paged"],
        ms=time_ms(lambda: run_decode(xd, G), flush=flush),
        plain_ms=time_ms(lambda: run_decode(xd, G, plain=True), flush=flush),
        bound_ms=d_bound, bound_by=d_by, library_ms=None))
    p_bytes, p_flops = prefill_cost(xp)
    p_bound, p_by = bound(p_bytes, p_flops)
    B, Sq, nh, dh = xp["q"].shape
    Sk = xp["k"].shape[1]
    kpos, qpos = torch.arange(Sk, device=dev), torch.arange(Sq, device=dev)
    mask = ((kpos[None, None, :] <= qpos[None, :, None] + xp["offs"][:, None, None])
            & (kpos[None, None, :] < xp["lens"][:, None, None]))[:, None]
    qt, kt, vt = (xp[n].transpose(1, 2) for n in ("q", "k", "v"))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  scale=xp["scale"], enable_gqa=True)
    rows.append(dict(
        name="flash_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:97",
        launches=launches["flash_prefill"], max_abs_err=errs["flash_prefill"],
        ms=time_ms(lambda: run_prefill(xp), flush=flush),
        plain_ms=time_ms(lambda: run_prefill(xp, plain=True), flush=flush),
        bound_ms=p_bound, bound_by=p_by, library_ms=time_ms(sdpa, flush=flush)))
    live = xd["lengths"].tolist()
    print(f"[{card}] shapes: decode B={len(live)} lengths={live} nh={cfg.n_heads} "
          f"nkv={cfg.n_kv_heads} 2r={2 * e.elite_r} d_c={e.d_ckv}; prefill "
          f"q={tuple(xp['q'].shape)} k={tuple(xp['k'].shape)} "
          f"q_offsets={xp['offs'].tolist()} kv_lens={xp['lens'].tolist()}")
    print(f"[{card}] decode bound: {d_bytes} B / 3.35 TB/s vs {d_flops} flop / 67 TFLOP/s; "
          f"prefill bound: {p_bytes} B vs {p_flops} flop")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms (SDPA)"
        print(f"[{card}] {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}, "
              f"launches {r['launches']}")
    print(f"[{card}] serving: decode tok/s={rep.tok_per_s:.1f} "
          f"ttft_ms p50={rep.ttft_wall_p50_ms:.1f} "
          f"step_ms p50/p95={rep.step_ms_p50:.2f}/{rep.step_ms_p95:.2f} "
          f"wall_s={rep.wall_s:.2f}", flush=True)

    # -- 5. result lines -----------------------------------------------------
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
