"""Time the kernel entry points of several source trees in turns, on one card.

    python3 chip_smoke.py            # records build/phase4_inputs.pt
    python3 kernel_turns.py TREE [TREE ...]

Each ``TREE`` is the root of a checkout of this repository: ``.`` for this
one, another commit unpacked with ``git archive`` into ``build/`` (which
``.gitignore`` lists).  The trees run in turns, in the order given and then
in reverse (A B B A for two), each turn in a process of its own that imports
that tree's ``repro_torch``, builds its kernels into the tree's own
``build/kernels/`` and calls each kernel's wrapper
(``kernels.ops.LAUNCHERS``) on every input:

* the busiest decode, verify and ``flash_prefill`` calls that
  ``chip_smoke.py`` phase 4 recorded from its main-path runs, and its four
  recorded rotations of a layer's q and k (``generate``'s prefill and
  decode, EliteKV and baseline);
* a verify call of 8 lanes over a full 72-tile walk (TinyLlama-1.1B widths,
  f32, 5-token windows ending at 1,152 - b), made from a seed;
* ``chip_smoke.py`` phase 2's rotation cases (``rope_cases`` through the
  one-tensor entry, ``rope_pair_cases`` through q and k), made from its
  seeds.

q and k rotate through the tree's ``ops.rope_elite_qk`` where it has one
(one launch), else as two calls of ``ops.rope_elite`` with the frequency
rows repeated for the heads (two launches: the trees before the pair
entry).  A time is ``chip_smoke.time_ms``: CUDA events, the launch queued
ahead, the L2 flushed before every launch.  Every output is checked
against the tree's plain version, within ``chip_smoke.TOL`` (a rotation:
``chip_smoke.rope_err``'s tolerance, with its bitwise-equal share
printed), and every launch count must rise by the launches of one call.
Prints one line per input with each turn's time in ms, then the card's
name and power limit.  Exits non-zero, having printed no times, if a turn
fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports no repro_torch at import)


def full_walk_verify(dev, W: int = 5, mb: int = 72, bs: int = 16, seed: int = 7):
    """The argument tuple of ``elite_verify_paged`` for 8 lanes whose windows
    of W tokens end at 1,152 - b: every lane walks all mb tiles."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    B, nh, nkv, r2, dc, dh = 8, 32, 4, 16, 64, 64
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c = f(B * mb * bs, dc)
    table = torch.randperm(B * mb, generator=g, device=dev).int().view(B, mb).contiguous()
    lens = torch.tensor([mb * bs - b for b in range(B)], dtype=torch.int32, device=dev)
    return (f(B, W, nh, r2), f(B, W, nh, dc), f(B * mb * bs, nkv, r2), c, c, table,
            lens - W, lens, nh // nkv, dh ** -0.5, bs)


def rotation(ops, ref, a):
    """(kernel call, plain call, launches per call) rotating q and k of
    ``a`` = (q, k, positions, freqs, q_per_row, k_per_row) on this tree."""
    if hasattr(ops, "rope_elite_qk"):
        return lambda: ops.rope_elite_qk(*a), lambda: ref.rope_elite_qk_ref(*a), 1
    return lambda: cs.rope_two_launches(a), lambda: cs.rope_two_launches(a, plain=True), 2


def one_turn(tree: str) -> int:
    """Time ``tree``'s wrappers on every input; prints one JSON line
    {label: {"ms": t, "err": e}}."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    calls = torch.load(cs.PHASE4_INPUTS, map_location=dev)
    calls["elite_verify_paged full 72-tile walk"] = ("elite_verify_paged",
                                                     full_walk_verify(dev))
    calls.update({f"rope_elite case {k}": ("rope_elite", a)
                  for k, a in cs.rope_cases(dev, seed=40).items()})
    calls.update({f"rope_elite_qk case {k}": ("rope_elite_qk", a)
                  for k, a in cs.rope_pair_cases(dev, seed=41).items()})
    flush = torch.empty(64 * 2**20 // 4, device=dev).zero_      # > the 50 MB L2
    out = {}
    for label, (name, a) in calls.items():
        if name.startswith("rope_elite"):
            if name == "rope_elite":
                fn, plain, n = (lambda: ops.rope_elite(*a)), (lambda: ref.rope_elite_ref(*a)), 1
            else:
                fn, plain, n = rotation(ops, ref, a)
            before = ops.launches()["rope_elite"]
            got = fn()
            if ops.launches()["rope_elite"] != before + n:
                raise AssertionError(f"{tree} {label}: {n} launches not counted")
            err, bad, same = cs.rope_err(got, plain())
            if bad:
                raise AssertionError(f"{tree} {label}: {bad} elements past the tolerance")
            out[label] = dict(ms=cs.time_ms(fn, flush=flush), err=err, same=same)
            continue
        fn = ops.LAUNCHERS[name]
        before = fn.launches
        got = fn(*a)
        if fn.launches != before + 1:
            raise AssertionError(f"{tree} {label}: the wrapper did not count its launch")
        err = cs.max_err(got, getattr(ref, name + "_ref")(*a))
        if not err <= cs.TOL:
            raise AssertionError(f"{tree} {label}: max abs err {err} > {cs.TOL}")
        out[label] = dict(ms=cs.time_ms(lambda: fn(*a), flush=flush), err=err)
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, timed A B ... B A")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_turn(args.trees[0])
    if not cs.PHASE4_INPUTS.exists():
        print(f"no inputs at {cs.PHASE4_INPUTS}: run chip_smoke.py first", file=sys.stderr)
        return 1
    card = cs.card_line()
    turns = []
    for tree in args.trees + args.trees[::-1]:
        r = subprocess.run([sys.executable, __file__, "--one", tree],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(f"turn on {tree} failed (exit {r.returncode}):\n{r.stdout}\n{r.stderr}",
                  file=sys.stderr)
            return 1
        turns.append((tree, json.loads(r.stdout.strip().splitlines()[-1])))
    for label in turns[0][1]:
        print(f"[{card}] {label}: " + "; ".join(
            f"{tree} {res[label]['ms']:.4f}" for tree, res in turns)
            + " ms; max abs err " + ", ".join(
            f"{tree} {res[label]['err']:.2e}" for tree, res in turns[:len(args.trees)])
            + "".join(f", bitwise equal {tree} {100 * res[label]['same']:.2f}%"
                      for tree, res in turns[:len(args.trees)] if "same" in res[label]),
            flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
