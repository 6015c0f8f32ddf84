"""Trace inspection CLI — summarize or diff mdmptrace Chrome traces (port
of ``repro.launch.trace``).

    PYTHONPATH=src python -m repro_torch.launch.trace /tmp/run.json
    PYTHONPATH=src python -m repro_torch.launch.trace --diff A.json B.json \
        [--threshold 0.5]

Summary mode re-prints what the run knew: per-track span totals, per-op
measured seconds, the decision instants, and the embedded calibration
ledger — everything reconstructed from the file alone, so a trace is a
self-contained artifact you can hand to someone without the repo state
that produced it.

Diff mode compares per-span-name mean durations between two traces and
exits non-zero when any shared hot path regressed by more than
``--threshold`` (relative, so 0.5 = +50%) — the CI hook that stops a
perf regression from landing silently.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from repro_torch.obs.export import load_trace, trace_tracks


def _spans(doc: dict) -> list[dict]:
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def _decisions(doc: dict) -> list[dict]:
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "i" and e.get("s") == "p"]


def _by_name(doc: dict) -> dict[str, tuple[int, float]]:
    """span name -> (count, total seconds)."""
    acc: dict[str, tuple[int, float]] = defaultdict(lambda: (0, 0.0))
    for e in _spans(doc):
        n, tot = acc[e["name"]]
        acc[e["name"]] = (n + 1, tot + float(e.get("dur", 0.0)) / 1e6)
    return dict(acc)


def summarize(path: str) -> None:
    doc = load_trace(path)
    other = doc.get("otherData", {})
    tracks = trace_tracks(doc)
    spans = _spans(doc)
    print(f"{path}: run={other.get('run', '?')} "
          f"{len(spans)} spans (dropped={other.get('dropped', 0)}), "
          f"{other.get('n_decisions', 0)} decisions")

    per_track: dict[str, tuple[int, float]] = defaultdict(lambda: (0, 0.0))
    for e in spans:
        name = tracks.get(e["tid"], f"tid{e['tid']}")
        n, tot = per_track[name]
        per_track[name] = (n + 1, tot + float(e.get("dur", 0.0)) / 1e6)
    print("tracks:")
    for name, (n, tot) in sorted(per_track.items(),
                                 key=lambda kv: -kv[1][1]):
        print(f"  {name:<16} {n:4d} spans  {tot * 1e3:10.2f} ms")

    print("hot paths:")
    for name, (n, tot) in sorted(_by_name(doc).items(),
                                 key=lambda kv: -kv[1][1]):
        print(f"  {name:<22} {n:4d} x {tot / n * 1e6:10.1f} us "
              f"= {tot * 1e3:8.2f} ms")

    decs = _decisions(doc)
    if decs:
        print("decisions:")
        for e in decs:
            a = e.get("args", {})
            print(f"  {a.get('op', '?')}[{a.get('axis', '?')}] "
                  f"mode={a.get('mode', '?')} chunks={a.get('chunks')} "
                  f"nbytes={a.get('nbytes')} "
                  f"bulk={a.get('predicted_bulk_s', 0):.3e}s "
                  f"chosen={a.get('predicted_interleaved_s', 0):.3e}s")

    cal = other.get("calibration")
    if cal:
        print(f"calibration: coverage {cal.get('coverage', 0) * 100:.0f}%")
        for key, r in sorted(cal.get("ratios", {}).items()):
            flag = (" MISCALIBRATED"
                    if key in cal.get("miscalibrated", {}) else "")
            print(f"  {key} ratio={r:.2f}{flag}")


def diff(path_a: str, path_b: str, threshold: float) -> int:
    a, b = load_trace(path_a), load_trace(path_b)
    na, nb = _by_name(a), _by_name(b)
    shared = sorted(set(na) & set(nb))
    only_a, only_b = sorted(set(na) - set(nb)), sorted(set(nb) - set(na))
    print(f"diff {path_a} -> {path_b}: {len(shared)} shared hot paths, "
          f"threshold +{threshold * 100:.0f}%")
    worst = 0.0
    failed = []
    for name in shared:
        ca, ta = na[name]
        cb, tb = nb[name]
        mean_a, mean_b = ta / ca, tb / cb
        rel = (mean_b - mean_a) / mean_a if mean_a > 0 else 0.0
        worst = max(worst, rel)
        mark = ""
        if rel > threshold:
            failed.append(name)
            mark = "  REGRESSED"
        print(f"  {name:<22} {mean_a * 1e6:10.1f}us -> "
              f"{mean_b * 1e6:10.1f}us ({rel * 100:+7.1f}%){mark}")
    for name in only_a:
        print(f"  {name:<22} only in {path_a}")
    for name in only_b:
        print(f"  {name:<22} only in {path_b}")
    if failed:
        print(f"FAIL: {len(failed)} hot path(s) regressed past "
              f"+{threshold * 100:.0f}%: {', '.join(failed)}")
        return 1
    print(f"OK: worst shared-path change {worst * 100:+.1f}%")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize one mdmptrace Chrome trace, or --diff two")
    ap.add_argument("paths", nargs="+", metavar="TRACE.json")
    ap.add_argument("--diff", action="store_true",
                    help="compare two traces (per-span-name mean "
                         "durations); exit 1 on a regression past "
                         "--threshold")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="relative regression bound for --diff "
                         "(0.5 = +50%%)")
    args = ap.parse_args(argv)
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two trace files")
        return diff(args.paths[0], args.paths[1], args.threshold)
    for p in args.paths:
        summarize(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
