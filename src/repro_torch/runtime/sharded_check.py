"""Multi-replica serving check: the router's streams against one Scheduler's.

The port's counterpart of the JAX package's ``runtime/sharded_check.py``,
for data parallelism (``--dp``):

    PYTHONPATH=src python -m repro_torch.runtime.sharded_check \\
        --dp 2 --device cpu --scenarios plain,recompute,prefix,int8,spec

It serves a fixed seeded request set (greedy) through each scenario on a
tiny 2-layer EliteKV model and prints ONE JSON object on stdout:
per-scenario ``{uid: tokens}`` streams plus report fields (tok/s, TTFT
percentiles, preemptions, routing, per-replica occupancy and kernel
launches).  The caller compares the token streams across ``--dp``
settings: the router's replicas are independent schedulers and a token
never depends on the replica it was served by, so ``tokens`` must match
the ``--dp 1`` run's exactly on the CPU.  ``main`` is callable in-process
too (``main([...])`` returns the object it prints).

``--device`` places the replicas (``launch/mesh.py::replica_devices``): a
bare ``cuda`` puts replica ``i`` on card ``i``, an explicit ``cuda:0`` or
``cpu`` every replica on that device.  Tensor-parallel serving (``--tp >
1``) and the reference's ``--parity`` check of the head-sharded epilogue
are ROADMAP item 15b.2 and raise ``ValueError`` (the head-sharded attention
itself is ported: ``kernels/ops.py``'s ``*_tp`` wrappers).

Scenario knobs mirror launch/serve.py flags: ``plain`` (chunked prefill +
swap eviction under pool pressure), ``recompute`` (the same, recompute
eviction), ``prefix`` (prefix cache + a shared prompt prefix), ``int8``
(quantized pool), ``spec`` (self-speculative decode); and the port's
``sampled`` (nucleus sampling, temperature 0.8, top-p 0.9, seed 100 + uid).
"""
from __future__ import annotations

import argparse
import json
import sys

# SchedulerConfig overrides per scenario; "shared" is the shared-prompt-prefix
# length (a request-builder knob, not a SchedulerConfig field)
SCENARIOS = {
    "plain": dict(eviction="swap"),
    "recompute": dict(eviction="recompute"),
    "prefix": dict(prefix_cache=True, shared=16),
    "int8": dict(cache_dtype="int8"),
    "spec": dict(speculate_k=2),
}
# the port's sampled scenario: request-builder knobs only
SAMPLED = {"sampled": dict(temperature=0.8, top_p=0.9)}
REQUEST_KNOBS = ("shared", "temperature", "top_p")
N_REQUESTS = 6
NEW_TOKENS = 8


def scenario_knobs(name: str):
    """→ (SchedulerConfig overrides, request-builder knobs) of ``name``."""
    kw = dict({**SCENARIOS, **SAMPLED}[name])
    req = {k: kw.pop(k) for k in REQUEST_KNOBS if k in kw}
    return kw, req


def build_requests(prompts, new_tokens: int = NEW_TOKENS, shared: int = 0,
                   temperature: float = 0.0, top_p: float = 1.0, per_step: int = 2):
    """Fresh Request objects every call (``generated`` is mutable, so
    reusing requests across runs would leak one run's tokens into the
    next): ``shared`` tokens 1.. before every prompt, ``per_step``
    arrivals per step, request ``i`` seeded ``100 + i``."""
    from repro_torch.runtime import serve_loop
    pre = list(range(1, 1 + shared))
    return [serve_loop.Request(uid=i, prompt=pre + list(p), max_new_tokens=new_tokens,
                               arrival=i // per_step, temperature=temperature,
                               top_p=top_p, seed=100 + i)
            for i, p in enumerate(prompts)]


def serve(params, buffers, cfg, scfg, reqs, devices):
    """Serve ``reqs`` through one Scheduler (one device) or a Router over
    ``devices``.  → (finished tokens {uid: tokens}, report fields)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve_loop
    from repro_torch.runtime.router import Router
    if len(devices) > 1:
        router = Router(params, buffers, cfg, scfg, num_replicas=len(devices),
                        devices=devices)
        rep = router.run(reqs)
        return router.finished_tokens(), {
            "completed": rep.completed, "tok_s": rep.tok_per_s,
            "ttft_wall_p50_ms": rep.ttft_wall_p50_ms,
            "ttft_wall_p95_ms": rep.ttft_wall_p95_ms,
            "preemptions": rep.preemptions, "routed": rep.routed,
            "imbalance": rep.imbalance,
            "occupancy_per_replica": [r.mean_occupancy for r in rep.replicas],
            "launches_per_replica": rep.launches,
            "pool_bytes_per_token": router.replicas[0].pool.bytes_per_token(),
        }
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=devices[0])
    n0 = ops.launches()
    rep = sched.run(reqs)
    launches = {k: v - n0[k] for k, v in ops.launches().items() if v != n0[k]}
    return {r.uid: list(r.generated) for r in sched.finished}, {
        "completed": rep.completed, "tok_s": rep.tok_per_s,
        "ttft_wall_p50_ms": rep.ttft_wall_p50_ms,
        "ttft_wall_p95_ms": rep.ttft_wall_p95_ms,
        "preemptions": rep.preemptions, "routed": [rep.completed],
        "imbalance": 1.0, "occupancy_per_replica": [rep.mean_occupancy],
        "launches_per_replica": [launches],
        "pool_bytes_per_token": sched.pool.bytes_per_token(),
    }


def run_scenario(name, params, buffers, cfg, devices, prompts):
    from repro_torch.runtime import serve_loop
    kw, req = scenario_knobs(name)
    scfg = serve_loop.SchedulerConfig(
        max_slots=2, block_size=8, num_blocks=24, prefill_chunk_tokens=8,
        max_new_tokens=NEW_TOKENS, **kw)
    tokens, report = serve(params, buffers, cfg, scfg, build_requests(prompts, **req),
                           devices)
    return {"tokens": {str(u): t for u, t in sorted(tokens.items())}, "report": report}


def tiny_model(device):
    """The 2-layer EliteKV TinyLlama (vocab 128, r 4, d_ckv 64) from seed 0,
    and the fixed prompts (12..17 tokens, seed 7)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=128).with_elitekv(
        elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device=device)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, 128, 12 + i))) for i in range(N_REQUESTS)]
    return cfg, params, buffers, prompts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="replica placement: cuda (replica i on card i), or one "
                         "device for every replica (cuda:0, cpu)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--scenarios", default="plain",
                    help=f"comma list from {sorted({**SCENARIOS, **SAMPLED})}")
    ap.add_argument("--parity", action="store_true",
                    help="the reference's head-sharded epilogue parity check "
                         "(tensor-parallel serving: not ported)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import TP_NOT_PORTED, replica_devices
    if args.parity:
        raise ValueError(TP_NOT_PORTED)
    names = args.scenarios.split(",")
    unknown = sorted(set(names) - set(SCENARIOS) - set(SAMPLED))
    if unknown:
        ap.error(f"unknown scenarios {unknown}")
    devices = replica_devices(dp=args.dp, device=args.device, tp=args.tp)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, buffers, prompts = tiny_model(devices[0])
    result = {"devices": [str(d) for d in devices], "tp": args.tp, "dp": args.dp,
              "scenarios": {name: run_scenario(name, params, buffers, cfg, devices, prompts)
                            for name in names}}
    json.dump(result, sys.stdout)
    return result


if __name__ == "__main__":
    main()
