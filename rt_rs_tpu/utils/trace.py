"""Device time from a ``jax.profiler`` trace, by span.

The frame's spans are ``jax.named_scope`` names in the compiled
program: ``cull`` (chunk culling and list compaction), ``intersect``
(the chunk loop) and ``shade`` (hit rows and shading).  A device event
belongs to ``intersect`` when it is a packet kernel (``packet_*``),
else to the first span that appears as ``/<span>/`` in its ``tf_op``
stat (XLA's op-name path, present when the program runs without CUDA
command buffers: ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``);
everything else is ``other``.  Busy time is the union of the event
intervals on the device's stream lines; idle share is one minus busy
over the window from the first event's start to the last one's end.
"""

from __future__ import annotations

import glob
import os

SPANS = ("cull", "intersect", "shade")


def _events(path: str):
    """(device plane name, line name, event name, text, start, end) of
    every event on a GPU device plane."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                text = [ev.name]
                for name, value in ev.stats:
                    if isinstance(value, str):
                        text.append(f"{name}={value}")
                        if name == "tf_op":
                            text.append(f"/{value}/")
                start = ev.start_ns
                yield (plane.name, line.name, ev.name, " ".join(text),
                       start, start + ev.duration_ns)


def device_breakdown(trace_dir: str) -> dict:
    """Device milliseconds by span, busy and idle share of the window
    (first GPU device of the newest trace under ``trace_dir``)."""
    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    events = list(_events(files[-1]))
    planes = sorted({e[0] for e in events})
    if not planes:
        raise ValueError("trace holds no GPU device events")
    events = [e for e in events if e[0] == planes[0]]
    streams = [e for e in events if e[1].startswith("Stream")] or events
    by_span = {s: 0.0 for s in SPANS + ("other",)}
    for _, _, name, text, start, end in streams:
        if name.startswith("packet_"):
            span = "intersect"
        else:
            span = next((s for s in SPANS if f"/{s}/" in text), "other")
        by_span[span] += (end - start) / 1e6
    busy = 0
    cur_start = cur_end = None
    for _, _, _, _, start, end in sorted(streams, key=lambda e: e[4]):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(e[5] for e in streams) - min(e[4] for e in streams)
    lines = sorted({e[1] for e in events})
    return {
        "device_plane": planes[0],
        "lines": lines,
        "ms_by_span": by_span,
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window,
        "sample_events": [e[3][:300] for e in streams[:12]],
    }
