"""Where a traced run's time went, by the program's own spans.

Reads a Chrome trace of `torch.profiler` (`python -m geneevolve_tpu_torch
... --profile DIR` writes `DIR/*.pt.trace.json`) and prints, as one JSON
object: the window (the span named `--window`, else from the first program
span to the last), the device's busy seconds (the union of its kernels,
copies and sets), each span name's wall seconds (the union of its
intervals) and calls, and the device's idle seconds under each innermost
span (`run` where none is open):

    python -m geneevolve_tpu_torch.utils.trace_spans DIR/*.pt.trace.json \
        [--window NAME]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "run"


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, a, b, at=0):
    """Seconds of [a, b) the merged intervals cover, scanning from index
    `at` (both sorted); returns (covered, the index to scan from next)."""
    while at < len(merged) and merged[at][1] <= a:
        at += 1
    got, i = 0.0, at
    while i < len(merged) and merged[i][0] < b:
        got += min(b, merged[i][1]) - max(a, merged[i][0])
        i += 1
    return got, at


def summarize(events: list, window: str = None) -> dict:
    """The breakdown of a trace's events (times in seconds)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e]
    if window:
        lo, hi = next((a, b) for a, b, n in spans if n == window)
        spans = [s for s in spans if s[2] != window]
    else:
        lo, hi = min(s[0] for s in spans), max(s[1] for s in spans)
    busy = _union((max(float(e["ts"]), lo),
                   min(float(e["ts"]) + float(e["dur"]), hi))
                  for e in events if e.get("cat") in DEVICE_CATS
                  and "dur" in e)
    busy = [iv for iv in busy if iv[1] > iv[0]]
    # the innermost open span between consecutive span boundaries: spans of
    # one thread nest, so it is the open span that started last
    marks = sorted([(a, 1, -b, i) for i, (a, b, _) in enumerate(spans)]
                   + [(b, 0, -a, i) for i, (a, b, _) in enumerate(spans)])
    idle, open_, at, t = {}, [], 0, lo
    for x, start, _, i in marks + [(hi, 0, 0, None)]:
        x = min(max(x, lo), hi)
        if x > t:
            label = spans[open_[-1]][2] if open_ else NO_SPAN
            got, at = _overlap(busy, t, x, at)
            idle[label] = idle.get(label, 0.0) + (x - t - got) / 1e6
            t = x
        if i is None:
            break
        if start:
            open_.append(i)
        else:
            open_.remove(i)
    names = {}
    for a, b, n in spans:
        names.setdefault(n, []).append((a, b))
    return dict(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        span_s={n: sum(b - a for a, b in _union(iv)) / 1e6
                for n, iv in sorted(names.items())},
        calls={n: len(iv) for n, iv in sorted(names.items())},
        idle_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--window", default=None)
    args = ap.parse_args(argv)
    events = json.loads(Path(args.trace).read_text())["traceEvents"]
    print(json.dumps(summarize(events, args.window), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
