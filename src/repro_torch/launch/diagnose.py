"""The JAX package's ``launch/diagnose.py``: a cell's dry-run report, and
offline trace analysis.

A cell's per-device memory and FLOPs (``launch/dryrun.py``'s record):

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch tinyllama_1_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch tinyllama_1_1b --shape train_4k \
      --one-card --batch 8 --seq-len 512

prints the peak, temp and resident bytes per device, the FLOPs per device,
the kernels' calls, bytes and FLOPs, and the largest tensors live at the
peak with their shapes, dtypes and the operators that made them.  On the
production meshes (``--multi-pod`` for 2 × 16 × 16) the train, prefill
and decode steps of a stack without MoE layers are traced sharded (rank 0
of a fake group; a decode step on the cache placed by the decode plan,
its sequence over "model"), and the report adds each collective kind's
count and bytes per device; MoE cells (ROADMAP item 15d) and the
baseline's decode without EliteKV (item 15c.3) keep a ``null`` peak and
temp, with the reason, and an even split of the FLOPs.
``--one-card`` takes a 1 × 1 mesh, whose step is traced and sends
nothing.  The dry run imports PyTorch; ``trace-summary`` uses the
standard library only.

Summarise a Chrome trace written by ``launch/serve.py --trace``:

  PYTHONPATH=src python -m repro_torch.launch.diagnose trace-summary trace.json [--top 8]

prints the phase-time table, kernel-span totals, swap spans, the
per-request lifecycle table (TTFT / residency / retirement reason), the
most-preempted requests, and an ASCII pool-occupancy timeline — the
terminal view of what Perfetto renders graphically — exactly as the
reference prints them for the same file (its per-replica blocks too, for
traces of a data-parallel run).  Importing this module parses nothing
and imports no PyTorch.
"""
import argparse
import json
import re
import sys
from collections import Counter, defaultdict
from pathlib import Path

_SPARK = " ▁▂▃▄▅▆▇█"


def _sparkline(samples, width):
    """Bin (ts, value) samples into ``width`` columns of block glyphs; each
    column shows the max value seen in its time bin (last value carried
    forward through empty bins — counters hold between updates)."""
    if not samples:
        return "", 0.0
    t0, t1 = samples[0][0], samples[-1][0]
    span = max(t1 - t0, 1e-9)
    peak = max(v for _, v in samples) or 1.0
    cols = [None] * width
    for ts, v in samples:
        c = min(int((ts - t0) / span * width), width - 1)
        cols[c] = v if cols[c] is None else max(cols[c], v)
    out, last = [], 0.0
    for c in cols:
        last = last if c is None else c
        out.append(_SPARK[round(last / peak * (len(_SPARK) - 1))])
    return "".join(out), peak


def trace_summary(argv):
    ap = argparse.ArgumentParser(
        prog="diagnose trace-summary",
        description="summarise a Chrome trace written by serve.py --trace")
    ap.add_argument("trace", help="trace-event JSON path")
    ap.add_argument("--top", type=int, default=8,
                    help="rows in the preempted/requests tables")
    ap.add_argument("--width", type=int, default=64,
                    help="columns in the occupancy timeline")
    args = ap.parse_args(argv)

    events = json.loads(Path(args.trace).read_text())["traceEvents"]
    spans = defaultdict(lambda: [0.0, 0])     # (cat, name) -> [ms, calls]
    reqs = defaultdict(dict)                  # uid -> lifecycle timestamps
    preempts = Counter()
    occupancy, slots = [], []
    replica_occ = defaultdict(list)           # replica id -> (ts, blocks)
    routed = Counter()                        # replica id -> admissions
    for e in events:
        ph, name, uid = e.get("ph"), e.get("name", ""), \
            (e.get("args") or {}).get("uid")
        if ph == "X":
            agg = spans[(e.get("cat", "event"), name)]
            agg[0] += e.get("dur", 0.0) / 1e3
            agg[1] += 1
        elif ph == "i" and uid is not None:
            if name in ("submit", "first_token", "retire"):
                reqs[uid][name] = e["ts"]
                if name == "retire":
                    reqs[uid]["reason"] = e["args"].get("reason", "?")
                    reqs[uid]["tokens"] = e["args"].get("tokens", 0)
            elif name == "preempt":
                preempts[uid] += 1
        elif ph == "C" and name == "pool_blocks_used":
            occupancy.append((e["ts"], float(e["args"]["value"])))
        elif ph == "C" and name == "slots_occupied":
            slots.append((e["ts"], float(e["args"]["value"])))
        elif ph == "C":
            m = re.match(r"r(\d+)_pool_blocks_used$", name)
            if m:
                replica_occ[int(m.group(1))].append(
                    (e["ts"], float(e["args"]["value"])))
        if ph == "i" and name == "route":
            routed[(e.get("args") or {}).get("replica", "?")] += 1

    for cat, title in (("phase", "phase time"), ("kernel", "kernel spans"),
                       ("swap", "swap traffic")):
        rows = sorted(((n, ms, c) for (ct, n), (ms, c) in spans.items()
                       if ct == cat), key=lambda r: -r[1])
        if not rows:
            continue
        total = sum(ms for _, ms, _ in rows) or 1.0
        print(f"== {title} ==")
        for n, ms, c in rows:
            print(f"  {n:<14s} {ms:9.1f}ms  {c:5d} calls  "
                  f"{100 * ms / total:3.0f}%")

    done = sorted(reqs.items())
    if done:
        print(f"== requests ({len(done)} submitted, "
              f"{sum('retire' in r for _, r in done)} retired) ==")
        print(f"  {'uid':>4s} {'ttft_ms':>8s} {'total_ms':>9s} "
              f"{'tokens':>6s} {'reason':<7s} preempts")
        for uid, r in done[:args.top]:
            ttft = (f"{(r['first_token'] - r['submit']) / 1e3:8.1f}"
                    if "first_token" in r and "submit" in r else f"{'—':>8s}")
            total = (f"{(r['retire'] - r['submit']) / 1e3:9.1f}"
                     if "retire" in r and "submit" in r else f"{'—':>9s}")
            print(f"  {uid:>4d} {ttft} {total} {r.get('tokens', 0):>6} "
                  f"{r.get('reason', 'live'):<7s} {preempts.get(uid, 0)}")
        if len(done) > args.top:
            print(f"  ... {len(done) - args.top} more")
    if preempts:
        worst = ", ".join(f"req{u}×{c}" for u, c in
                          preempts.most_common(args.top))
        print(f"== top preempted requests ==\n  {worst} "
              f"({sum(preempts.values())} evictions total)")

    for samples, title, unit in ((occupancy, "pool occupancy", "blocks"),
                                 (slots, "slots occupied", "slots")):
        line, peak = _sparkline(samples, args.width)
        if line:
            t_ms = (samples[-1][0] - samples[0][0]) / 1e3
            print(f"== {title} (peak {peak:.0f} {unit} over {t_ms:.0f}ms) ==")
            print(f"  [{line}]")

    if replica_occ:                           # data-parallel run (router)
        print(f"== per-replica pool occupancy ({len(replica_occ)} "
              f"replicas) ==")
        for i in sorted(replica_occ):
            line, peak = _sparkline(replica_occ[i], args.width)
            print(f"  r{i} [{line}] peak {peak:.0f} blocks, "
                  f"{routed.get(i, 0)} routed")
    if routed:
        counts = [routed.get(i, 0) for i in sorted(routed)]
        lo, hi = min(counts), max(counts)
        ratio = "inf" if lo == 0 else f"{hi / lo:.2f}"
        print(f"== replica imbalance ==\n  routed={counts} max/min={ratio} "
              f"(1.00 = perfectly even)")


def _gib(n) -> str:
    return "null" if n is None else f"{n / 2**30:.2f} GiB"


def cell_report(argv):
    ap = argparse.ArgumentParser(
        prog="diagnose", description="per-device memory and FLOPs of a dry-run cell "
        "(or: diagnose trace-summary TRACE)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one-card", action="store_true", help="a 1 x 1 mesh: trace the step")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--no-elitekv", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from repro_torch.launch import dryrun
    res = dryrun.lower_cell(args.arch, args.shape, args.multi_pod,
                            elitekv=not args.no_elitekv, batch=args.batch,
                            seq_len=args.seq_len, top=args.top,
                            seq_parallel=not args.no_seq_parallel,
                            mesh_axes={"data": 1, "model": 1} if args.one_card else None)
    if res["skipped"]:
        print(f"{args.arch} {args.shape}: skipped ({res['reason']})")
        return res
    mem = res["memory"]
    seq_tp = res.get("decode_seq_tp")
    print(f"{res['arch']} {res['shape']} on {res['mesh']} ({res['chips']} chips): "
          f"{res['step']}, batch {res['global_batch']} x {res['seq_len']}"
          + ("" if seq_tp is None else
             f", cache sequence {'over' if seq_tp else 'whole on'} the model axis"))
    print(f"peak/device: {_gib(mem['peak_estimate_bytes'])}  (temp "
          f"{_gib(mem['temp_bytes'])}, resident {_gib(mem['argument_bytes'])})"
          + (f"  [{mem['reason']}]" if mem.get("reason") else
             f"  at {mem['peak_op']}"))
    print("resident/device: " + ", ".join(f"{k} {_gib(v['bytes'])}"
                                          for k, v in res["resident"].items()))
    print(f"flops/device: {res['flops_per_device']:.3e}"
          + (f"  ({res['flops_split']})" if res["flops_split"] else ""))
    for name, k in sorted(res["kernels"].items()):
        print(f"  kernel {name:20s} calls {k['calls']:6d}  {k['bytes'] / 2**30:9.3f} GiB  "
              f"{k['flops']:.3e} flops")
    colls = res["collectives"]
    if colls:
        print(f"collectives/device: {_gib(res['collective_bytes_per_device'])}")
        for kind, c in sorted(colls.items()):
            print(f"  {kind:18s} count {c['count']:6d}  {c['bytes'] / 2**30:9.3f} GiB")
    elif res["collective_bytes_per_device"] is None:
        print(f"collectives: not traced ({mem['reason']})")
    elif res["chips"] == 1:
        print("collectives: none (one device)")
    else:
        print("collectives: none traced (the one-device step at the per-device batch)")
    if res["largest_at_peak"]:
        print("\n== largest live tensors at the peak ==")
        for t in res["largest_at_peak"]:
            print(f"  {t['bytes'] / 2**30:8.3f} GiB  {t['dtype']}{t['shape']}  <- {t['op']}")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["trace-summary"]:
        return trace_summary(argv[1:])
    return cell_report(argv)


if __name__ == "__main__":
    main()
