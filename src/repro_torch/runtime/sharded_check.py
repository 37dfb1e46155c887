"""Multi-device serving check: sharded and routed streams against one
device's.

The port's counterpart of the JAX package's ``runtime/sharded_check.py``,
for tensor parallelism (``--tp``) and data parallelism (``--dp``):

    PYTHONPATH=src python -m repro_torch.runtime.sharded_check \\
        --tp 2 --dp 2 --device cpu --scenarios plain,recompute,prefix,int8,spec

It serves a fixed seeded request set (greedy) through each scenario on a
tiny 2-layer EliteKV model and prints ONE JSON object on stdout:
per-scenario ``{uid: tokens}`` streams plus report fields (tok/s, TTFT
percentiles, preemptions, routing, per-replica occupancy and kernel
launches, pool bytes per token per device).  The caller compares the token
streams across ``(tp, dp)`` settings: head shards give the unsharded
attention's bits, and the router's replicas are independent schedulers, a
token never depending on the replica it was served by, so ``tokens`` must
match the ``--tp 1 --dp 1`` run's exactly on the CPU.  ``main`` is callable
in-process too (``main([...])`` returns the object it prints).

``--device`` places the shards (``launch/mesh.py::replica_meshes``): a bare
``cuda`` puts replica ``i``'s shard ``j`` on card ``i·tp + j``, an explicit
``cuda:0`` or ``cpu`` every shard on that device.  One replica serves
through ``Scheduler(mesh=)``, several through ``Router(meshes=)``.

``--parity`` instead runs the reference's parity cases of the head-sharded
decode and verify (``kernels/ops.py``'s ``*_tp`` wrappers) on random
operands on ``--device``: decode at tp 2 and 4, verify at tp 2 and int8
decode at tp 2, each held bitwise to the port's own tp-1 call.

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


def serve(params, buffers, cfg, scfg, reqs, meshes):
    """Serve ``reqs`` through one Scheduler (one ``TPMesh``) or a Router over
    ``meshes``, one per replica.  → (finished tokens {uid: tokens}, report
    fields)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve_loop
    from repro_torch.runtime.router import Router
    if len(meshes) > 1:
        router = Router(params, buffers, cfg, scfg, num_replicas=len(meshes),
                        meshes=meshes)
        rep = router.run(reqs)
        return router.finished_tokens(), {
            "completed": rep.completed, "tok_s": rep.tok_per_s,
            "ttft_wall_p50_ms": rep.ttft_wall_p50_ms,
            "ttft_wall_p95_ms": rep.ttft_wall_p95_ms,
            "preemptions": rep.preemptions, "routed": rep.routed,
            "imbalance": rep.imbalance,
            "decode_steps": sum(r.decode_steps for r in rep.replicas),
            "prefill_chunks": sum(r.prefill_chunks for r in rep.replicas),
            "occupancy_per_replica": [r.mean_occupancy for r in rep.replicas],
            "launches_per_replica": rep.launches,
            "pool_bytes_per_token": router.replicas[0].pool.bytes_per_token(),
            "pool_bytes_per_token_per_device":
                router.replicas[0].pool.bytes_per_token_per_device(),
        }
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, mesh=meshes[0])
    n0 = ops.launches()
    rep = sched.run(reqs)
    launches = {k: v - n0[k] for k, v in ops.launches().items() if v != n0[k]}
    return {r.uid: list(r.generated) for r in sched.finished}, {
        "completed": rep.completed, "tok_s": rep.tok_per_s,
        "ttft_wall_p50_ms": rep.ttft_wall_p50_ms,
        "ttft_wall_p95_ms": rep.ttft_wall_p95_ms,
        "preemptions": rep.preemptions, "routed": [rep.completed],
        "imbalance": 1.0, "decode_steps": rep.decode_steps,
        "prefill_chunks": rep.prefill_chunks,
        "occupancy_per_replica": [rep.mean_occupancy],
        "launches_per_replica": [launches],
        "pool_bytes_per_token": sched.pool.bytes_per_token(),
        "pool_bytes_per_token_per_device": sched.pool.bytes_per_token_per_device(),
    }


def run_scenario(name, params, buffers, cfg, meshes, prompts):
    from repro_torch.runtime import serve_loop
    kw, req = scenario_knobs(name)
    scfg = serve_loop.SchedulerConfig(
        max_slots=2, block_size=8, num_blocks=24, prefill_chunk_tokens=8,
        max_new_tokens=NEW_TOKENS, **kw)
    tokens, report = serve(params, buffers, cfg, scfg, build_requests(prompts, **req),
                           meshes)
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


def run_parity(device) -> dict:
    """The reference's ``_run_parity`` cases through the port's ``*_tp``
    wrappers on ``device`` (every shard there), each held bitwise to the
    port's own tp-1 call on the same operands: decode at tp 2 and 4, verify
    at tp 2, int8 decode at tp 2.  Operands are drawn in the reference's
    order from ``default_rng(0)``.  → {case: equal}."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import TPMesh
    rng = np.random.default_rng(0)
    B, nh, nkv, r2, d_c, bs, nb = 3, 4, 4, 8, 4, 8, 6
    G = nh // nkv
    n_slots = nb * bs
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    f32 = lambda *s: t(rng.standard_normal(s), torch.float32)
    q_e, q_lat = f32(B, nh, r2), f32(B, nh, d_c)
    K, C = f32(n_slots, nkv, r2), f32(n_slots, d_c)
    bt = t(rng.integers(0, nb, (B, 4)), torch.int32)
    ln = t([5, 17, 30], torch.int32)
    out = {}
    ref = ops.elite_decode_paged(q_e, q_lat, K, C, C, bt, ln, G, 0.5, bs)
    for tp in (2, 4):
        got = ops.elite_decode_paged_tp(q_e, q_lat, K, C, C, None, bt, ln, G, 0.5, bs,
                                        mesh=TPMesh.on(device, tp))
        out[f"decode_tp{tp}"] = bool(torch.equal(got, ref))
    W = 3
    qv_e, qv_lat = f32(B, W, nh, r2), f32(B, W, nh, d_c)
    qo = t([2, 10, 20], torch.int32)
    refv = ops.elite_verify_paged(qv_e, qv_lat, K, C, C, bt, qo, ln, G, 0.5, bs)
    gotv = ops.elite_verify_paged_tp(qv_e, qv_lat, K, C, C, None, bt, qo, ln, G, 0.5, bs,
                                     mesh=TPMesh.on(device, 2))
    out["verify_tp2"] = bool(torch.equal(gotv, refv))
    Kq = t(rng.integers(-127, 127, (n_slots, nkv, r2)), torch.int8)
    Cq = t(rng.integers(-127, 127, (n_slots, d_c)), torch.int8)
    ks, cs = (t(rng.random((n_slots,)) + 0.1, torch.float32) for _ in range(2))
    refq = ops.elite_decode_paged_q8(q_e, q_lat, Kq, Cq, Cq, ks, cs, cs, bt, ln, G, 0.5, bs)
    gotq = ops.elite_decode_paged_tp(q_e, q_lat, Kq, Cq, Cq, (ks, cs, cs), bt, ln, G, 0.5, bs,
                                     mesh=TPMesh.on(device, 2))
    out["decode_q8_tp2"] = bool(torch.equal(gotq, refq))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="shard placement: cuda (replica i's shard j on card "
                         "i*tp + j), or one device for every shard (cuda:0, cpu)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--scenarios", default="plain",
                    help=f"comma list from {sorted({**SCENARIOS, **SAMPLED})}")
    ap.add_argument("--parity", action="store_true",
                    help="hold the head-sharded decode and verify bitwise to the "
                         "tp-1 call on random operands instead of serving scenarios")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import replica_meshes
    names = args.scenarios.split(",")
    unknown = sorted(set(names) - set(SCENARIOS) - set(SAMPLED))
    if unknown:
        ap.error(f"unknown scenarios {unknown}")
    meshes = replica_meshes(tp=args.tp, dp=args.dp, device=args.device)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"devices": [str(d) for m in meshes for d in m.devices], "tp": args.tp,
              "dp": args.dp}
    if args.parity:
        result["parity"] = run_parity(meshes[0].devices[0])
        json.dump(result, sys.stdout)
        return result
    cfg, params, buffers, prompts = tiny_model(meshes[0].devices[0])
    result["scenarios"] = {name: run_scenario(name, params, buffers, cfg, meshes, prompts)
                           for name in names}
    json.dump(result, sys.stdout)
    return result


if __name__ == "__main__":
    main()
