"""Frame timing + benchmark observability.

The reference's ``Scheduler`` trait (``src/lib/timing.rs:12-24``) serves
two purposes: GPU-completion backpressure (``DefaultScheduler``,
timing.rs:26-114 — a map_async round-trip because WASM lacks
``on_submitted_work_done``) and benchmarking (``BenchScheduler``,
timing.rs:116-309 — GPU timestamp queries feeding a live line chart
written to ``benchmark.png`` every 10 passes, with the handler's name
and byte footprint in the legend, timing.rs:339-360).

Under JAX the backpressure half is moot — dispatch is async and a frame
boundary is a ``block_until_ready`` — so ``DefaultScheduler`` reduces
to FPS pacing.  ``BenchScheduler`` keeps full parity: per-frame times,
running average, the 10-frame chart cadence, and the footprint legend.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from rt_rs_tpu.handlers.base import IntrsStats

# Chart cadence parity (timing.rs:128-134).
GRAPH_ENTRY_INTERVAL = 10
GRAPH_ENTRIES: int | None = None  # None = run forever


@dataclasses.dataclass
class DefaultScheduler:
    """FPS pacing (the reference's fixed-timestep accumulator,
    ``src/lib/mod.rs:324-417``, minus the GPU-poll backpressure)."""

    fps: int = 60
    _last: float = dataclasses.field(default_factory=time.perf_counter)

    def ready(self) -> bool:
        return (time.perf_counter() - self._last) >= 1.0 / self.fps

    def frame_done(self) -> None:
        self._last = time.perf_counter()

    def record(self, dt: float) -> None:  # Scheduler-protocol no-op
        pass

    def finish(self) -> None:
        pass


class BenchScheduler:
    """Per-frame timing + running-average chart (timing.rs parity)."""

    def __init__(
        self,
        stats: IntrsStats,
        out_path: str = "benchmark.png",
        interval: int = GRAPH_ENTRY_INTERVAL,
        max_entries: int | None = GRAPH_ENTRIES,
    ):
        self.stats = stats
        self.out_path = out_path
        self.interval = interval
        self.max_entries = max_entries
        self.times_ms: list[float] = []
        self.averages: list[float] = []
        self._chart_thread: threading.Thread | None = None

    @property
    def running_average_ms(self) -> float:
        if not self.times_ms:
            return 0.0
        return sum(self.times_ms) / len(self.times_ms)

    def record(self, dt: float) -> None:
        """Record one frame's seconds; refresh the chart every
        ``interval`` frames (timing.rs:163-183).

        Chart rendering happens on a background thread so it never
        pollutes the frame timing — the reference does the same with an
        mpsc channel + chart thread (timing.rs:145-192)."""
        self.times_ms.append(dt * 1e3)
        if len(self.times_ms) % self.interval == 0:
            self.averages.append(self.running_average_ms)
            if (
                self.max_entries is None
                or len(self.averages) <= self.max_entries
            ):
                if self._chart_thread is None or not self._chart_thread.is_alive():
                    self._chart_thread = threading.Thread(
                        target=self.render_chart, daemon=True
                    )
                    self._chart_thread.start()

    def render_chart(self) -> None:
        """Write the running-average line chart (timing.rs:311-416);
        legend = handler name + accel byte footprint, the source of the
        study's memory table.  Needs matplotlib, an optional
        dependency used by this chart alone."""
        try:
            import matplotlib
        except ImportError as e:
            raise RuntimeError(
                "the benchmark chart needs matplotlib, which is not "
                "installed (pip install matplotlib); the frame times "
                "are still returned"
            ) from e

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4.5))
        # Snapshot: record() appends from the measuring thread while
        # this daemon runs; computing xs and plotting from one list
        # copy keeps the lengths consistent.
        avgs = list(self.averages)
        xs = [(i + 1) * self.interval for i in range(len(avgs))]
        label = f"{self.stats.name} ({self.stats.size} B)"
        ax.plot(xs, avgs, marker="o", markersize=3, label=label)
        ax.set_xlabel("frame")
        ax.set_ylabel("avg frame time (ms)")
        ax.set_title("rt_rs_tpu benchmark")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(self.out_path, dpi=96)
        plt.close(fig)

    def finish(self) -> None:
        if self._chart_thread is not None and self._chart_thread.is_alive():
            self._chart_thread.join()
        if self.times_ms:
            # Only append a final point if record() didn't just do so
            # (avoids a duplicate, mislabeled last chart entry).
            if len(self.times_ms) % self.interval != 0:
                self.averages.append(self.running_average_ms)
            self.render_chart()


def run_benchmark_protocol(renderer, frames: int = 200, rotations: float = 5.0):
    """The study's measurement protocol: ``frames`` frames spread over
    ``rotations`` full camera orbits, average frame time (pdf p.19
    §4.2).  Returns (scheduler, mean_ms)."""
    import math

    sched = BenchScheduler(renderer.stats)
    # Warm-up: XLA compilation happens on the first call; the reference
    # pays its (trivial) pipeline build before the event loop, so a
    # jit compile inside the timed window would be dishonest in the
    # other direction.
    renderer.render_frame(block=True)
    # orbit() advances 0.0314 * mult radians (camera.rs:181).
    mult = (rotations * 2.0 * math.pi) / frames / 0.0314

    def on_frame(i, frame, dt):
        sched.record(dt)

    # Coarse sync cadence: the host keeps up to 50 frames in flight, so
    # per-frame dispatch overlaps device work.
    renderer.animate(
        frames, orbit_mult=mult, on_frame=on_frame,
        sync_every=min(50, frames),
    )
    sched.finish()
    return sched, sched.running_average_ms
