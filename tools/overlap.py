"""Per-batch stage-overlap analysis of the streaming pipeline (VERDICT r4 #1).

Runs one warmed, timed encode with FLACENC_TIMELINE=1 and reconstructs
from the event stamps where the wall time actually went:

- main-thread classification: read (read_start->read_done), submit CPU
  (submit->packed: wire scan + pack — since r5 the upload RPCs run on
  the io workers, so the main-thread span must close at the `packed`
  mark, NOT at `issued` which is now stamped on the io thread after the
  device_put round trips), drain-blocked (drain_start->drain_done,
  waiting on an io future), and the residual ("other": frame
  bookkeeping, enqueue, finalization, loop glue);
- io-thread spans: per-batch fetch walls, per-group roundtrip walls,
  assembly walls;
- the headline number: `unhidden_host_s` = wall - drain_blocked - the
  pure link floor estimate, i.e. how much host-stage time is NOT hidden
  under transfers. VERDICT r4's target is wall - submit <= ~0.05 s;
  this tool shows which stage still serializes when it is not.

Emits one JSON line and (with --out) a markdown table.
Usage: python tools/overlap.py [--seconds 600] [--batch 256]
       [--trials 3] [--out report/overlap.md]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def analyze(timeline, wall_s):
    """Classify the wall from the event stamps (see module docstring)."""
    ev = sorted(timeline, key=lambda e: e[2])
    spans = {"read": [], "submit": [], "drain": []}
    open_t = {}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "read_start":
            open_t["read"] = t
        elif name == "read_done" and "read" in open_t:
            spans["read"].append((open_t.pop("read"), t))
        elif name == "submit":
            open_t[("submit", idx)] = t
        elif name == "packed" and ("submit", idx) in open_t:
            # close at the main-thread `packed` mark: `issued` moved to
            # the io thread in r5 (it now trails the upload RPCs), so
            # closing there would misattribute hidden link wait — from
            # overlapping in-flight batches — to main-thread submit CPU
            spans["submit"].append((open_t.pop(("submit", idx)), t))
        elif name == "drain_start":
            open_t["drain"] = t
        elif name == "drain_done" and "drain" in open_t:
            spans["drain"].append((open_t.pop("drain"), t))
    # drain spans can nest INSIDE submit spans (submit() calls drain_one
    # at depth): subtract overlap so the classes partition the wall
    def total(key):
        return sum(b - a for a, b in spans[key])

    drain_in_submit = 0.0
    for a, b in spans["drain"]:
        for c, d in spans["submit"]:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                drain_in_submit += hi - lo
    sub = {
        "read_s": round(total("read"), 3),
        "submit_cpu_s": round(total("submit") - drain_in_submit, 3),
        "drain_blocked_s": round(total("drain"), 3),
    }
    sub["other_s"] = round(
        wall_s - sub["read_s"] - sub["submit_cpu_s"]
        - sub["drain_blocked_s"], 3
    )
    # io-thread stage walls (overlap the above; reported for attribution)
    fetch = {}
    io = {"fetch_walls": [], "gtrip_walls": []}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "fetch_start":
            fetch[idx] = t
        elif name == "fetch_done" and idx in fetch:
            io["fetch_walls"].append(t - fetch.pop(idx))
        elif name == "gtrip_start":
            # idx is a per-group unique id: concurrent group roundtrips
            # (depth > G allows several in flight) must not clobber
            # each other's start stamps under one shared key
            fetch[("g", idx)] = t
        elif name == "gasm_done" and ("g", idx) in fetch:
            io["gtrip_walls"].append(t - fetch.pop(("g", idx)))
    sub["fetch_wall_mean_s"] = round(
        float(np.mean(io["fetch_walls"])), 4) if io["fetch_walls"] else None
    sub["gtrip_wall_mean_s"] = round(
        float(np.mean(io["gtrip_walls"])), 4) if io["gtrip_walls"] else None
    sub["n_fetches"] = len(io["fetch_walls"])
    sub["n_group_trips"] = len(io["gtrip_walls"])
    return sub


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--warm-seconds", type=float, default=60.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--gap", type=float, default=20.0)
    ap.add_argument("--rate", type=int, default=44100)
    ap.add_argument("--bps", type=int, default=16)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    os.environ["FLACENC_TIMELINE"] = "1"

    from hwconfigs import stereo_audio

    def make_audio(seconds, rate):
        return stereo_audio(seconds, rate, args.bps)

    from flacenc_tpu import config
    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.source import MemSource

    cfg = config.Encoder().into_verified()
    rate, bps, block = args.rate, args.bps, 4096
    warm = make_audio(args.warm_seconds, rate)
    be.encode_with_fixed_block_size(
        cfg, MemSource(warm, 2, bps, rate), block, batch_size=args.batch,
    )
    be.wait_all_warms(timeout=600)

    audio = make_audio(args.seconds, rate)
    n_samples = len(audio) // 2
    results = []
    for i in range(args.trials):
        if i:
            time.sleep(args.gap)
        stats = {}
        t0 = time.perf_counter()
        be.encode_with_fixed_block_size(
            cfg, MemSource(audio, 2, bps, rate), block,
            batch_size=args.batch, stats=stats,
        )
        wall = time.perf_counter() - t0
        sub = analyze(stats.get("timeline", []), wall)
        wires = stats.get("wire_batches") or {}
        sub.update(
            wall_s=round(wall, 3),
            x_realtime=round((n_samples / rate) / wall, 1),
            link_mbps=stats.get("link_mbps"),
            grouped_batches=stats.get("grouped_batches"),
            device_wait_s=round(stats.get("device_wait_s", 0.0), 3),
            pack_s=round(stats.get("pack_s", 0.0), 3),
            wire=(max(wires, key=wires.get) if wires else None),
        )
        results.append(sub)
        print(json.dumps({"trial": i, **sub}), flush=True)

    best = max(results, key=lambda r: r["x_realtime"])
    print(json.dumps({"best": best}), flush=True)
    if args.out:
        lines = [
            "# Pipeline stage overlap (tools/overlap.py)",
            "",
            f"Audio: {args.seconds:.0f} s {args.bps}/"
            f"{args.rate / 1000:g} stereo, batch "
            f"{args.batch}, fetch group "
            f"{os.environ.get('FLACENC_FETCH_GROUP')}. The wall is "
            "partitioned into main-thread classes; io-thread walls "
            "overlap them and are listed for attribution.",
            "",
            "| trial | wall s | x-rt | read | submit cpu | drain "
            "blocked | other | fetch mean | gtrip mean | link MB/s |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for i, r in enumerate(results):
            lines.append(
                f"| {i} | {r['wall_s']} | {r['x_realtime']} | "
                f"{r['read_s']} | {r['submit_cpu_s']} | "
                f"{r['drain_blocked_s']} | {r['other_s']} | "
                f"{r['fetch_wall_mean_s']} | {r['gtrip_wall_mean_s']} | "
                f"{r['link_mbps']} |"
            )
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
