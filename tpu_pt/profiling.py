"""Render profiling and statistics reporting.

Parity with the reference's observability surface (SURVEY.md §5.1/§5.5):
- per-frame timing + running averages (``PathTracerMain.cpp:703-740``)
- windowed FPS (``sutil::displayFPS``, ``sutil.cpp:712-734``)
- per-stage stats overlay (``sutil::displayStats``, ``sutil.cpp:735-774``)
plus the framework's own telemetry: Mrays/s, wavefront occupancy, and the
DoneReason termination histogram. Also wraps ``jax.profiler`` tracing for
kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


def require_gpu(tool: str) -> None:
    """Exit unless JAX's default backend is a GPU: timings are only
    recorded on the device they describe."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"{tool}: needs a GPU (JAX backend is "
                         f"{backend!r})")


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    import jax
    dev = jax.devices()[0]
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))


def card_line() -> str:
    """``name, power.limit`` of the first GPU, from nvidia-smi."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


@dataclasses.dataclass
class FrameRecord:
    ms: float
    rays: float
    shadow_rays: float
    iterations: float
    done_histogram: np.ndarray


class RenderProfiler:
    """Accumulates per-frame statistics for a render session."""

    REASONS = ("MISS", "MAX_DEPTH", "RUSSIAN_ROULETTE", "LIGHT_HIT",
               "NOT_DONE")

    def __init__(self, lanes: int | None = None):
        self.frames: list[FrameRecord] = []
        self.lanes = lanes
        self._t0 = None

    @contextlib.contextmanager
    def frame(self, stats=None):
        """Time one frame; pass RenderStats afterwards via record()."""
        t0 = time.perf_counter()
        yield
        self._t0 = (time.perf_counter() - t0) * 1e3

    def record(self, stats, ms: float | None = None) -> FrameRecord:
        rec = FrameRecord(
            ms=self._t0 if ms is None else ms,
            rays=float(stats.rays_traced),
            shadow_rays=float(stats.shadow_rays),
            iterations=float(stats.wavefront_iterations),
            done_histogram=np.asarray(stats.done_histogram),
        )
        self.frames.append(rec)
        return rec

    # -- aggregates --------------------------------------------------------
    @property
    def total_ms(self) -> float:
        return sum(f.ms for f in self.frames)

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(len(self.frames), 1)

    @property
    def mrays_per_sec(self) -> float:
        rays = sum(f.rays + f.shadow_rays for f in self.frames)
        return rays / max(self.total_ms / 1e3, 1e-9) / 1e6

    def occupancy(self) -> float:
        """Useful path segments / (iterations x lanes) — the wavefront's
        effective utilization (the metric SER optimizes in the reference)."""
        if self.lanes is None:
            return float("nan")
        segs = sum(f.rays for f in self.frames)
        slots = sum(f.iterations for f in self.frames) * self.lanes
        return segs / max(slots, 1e-9)

    def termination_histogram(self) -> dict[str, int]:
        total = np.zeros(5)
        for f in self.frames:
            total += f.done_histogram
        return {name: int(v) for name, v in zip(self.REASONS, total)}

    def report(self) -> str:
        """Human-readable stats block (displayStats parity)."""
        hist = self.termination_histogram()
        paths = max(sum(hist.values()), 1)
        lines = [
            f"frames rendered : {len(self.frames)}",
            f"avg frame time  : {self.avg_ms:9.1f} ms",
            f"total time      : {self.total_ms:9.1f} ms",
            f"throughput      : {self.mrays_per_sec:9.2f} Mrays/s",
        ]
        if self.lanes is not None:
            lines.append(f"occupancy       : {self.occupancy() * 100:8.1f} %")
        lines.append("termination     : " + ", ".join(
            f"{k}={v} ({100.0 * v / paths:.0f}%)" for k, v in hist.items()
            if v or k != "NOT_DONE"))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace (open with xprof/tensorboard).

    The reference's analog is building with -lineinfo for Nsight
    (``CMakeLists.txt:268``)."""
    import jax
    with jax.profiler.trace(logdir):
        yield
