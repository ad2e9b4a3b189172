"""What every kind of cell shares. A traffic file names its ``kind``; the
routine that runs it is ``run(Run) -> Result`` in
``vio_bench/kinds/<kind>.py``, found by that name (``Registry.kind``), so
a later kind of traffic is a file of its own. A kind warms every shape up
first (the first call captures the step), counts that as set-up, measures,
and keeps what the comparison needs: the program's initial state, and its
states before and after the frames the seed draws for the check, with
their outputs. ``Result.e2e`` holds every end-to-end metric the kind
measures, under its name in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from vio_bench.trace import TraceRecord

IMU_KEYS = ("imu_t", "imu_w", "imu_a", "imu_valid")
NULL = contextlib.nullcontext()
SPIN_CYCLES = 400_000_000  # ~0.2 s of the card's clock: the host enqueues the timed calls meanwhile
SPIN_CALLS = 10
SPIN_ONE = 40_000_000  # ~0.02 s: behind it the host enqueues one call


@dataclasses.dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    traffic: dict  # the cell's traffic file
    config: dict  # the configuration file
    t_start: float  # process start, on perf_counter's clock


@dataclasses.dataclass
class Result:
    e2e: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    initial: object  # the program's initial state, one instance
    checked: list  # compare.Frame of the frames the comparison checks
    record: TraceRecord | None = None
    lines: list = dataclasses.field(default_factory=list)  # diagnostics for earlier lines
    unchecked: int = 0  # frames the check drew that never came to be checked


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spans(on: bool):
    return (lambda name: torch.profiler.record_function(name)) if on else (lambda name: NULL)


def wait_until(t: float) -> None:
    """Sleep to about 2 ms before ``t``, then spin to it."""
    left = t - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.002)
    while time.perf_counter() < t:
        pass


def mode_line(ms, fast, what: str) -> str:
    if ms is None:
        return f"replay: the card's ms per {what} not measured"
    mode = "unknown" if not fast else ("slow" if ms > 1.12 * fast else "fast")
    return f"replay: {ms:.4f} ms per {what} on the card alone (warm-up); mode {mode} (fast ~{fast} ms)"


def device_ms(dev, calls, cycles: int = SPIN_CYCLES) -> float | None:
    """The card's ms per call of ``calls`` (a list of thunks), enqueued
    behind a spin kernel so that no call waits for the host; None off the
    card, or where the host took longer to enqueue them than the spin lasted."""
    if dev.type != "cuda":
        return None
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    sync(dev)
    h0 = time.perf_counter()
    spin.record()
    torch.cuda._sleep(cycles)
    start.record()
    for c in calls:
        c()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - h0)
    sync(dev)
    spin_ms = spin.elapsed_time(start)
    if host_ms >= 0.9 * spin_ms:
        print(f"replay: the host took {host_ms:.1f} ms to enqueue {len(calls)} calls, the spin lasted {spin_ms:.1f} ms",
              flush=True)
        return None
    return start.elapsed_time(end) / len(calls)


def device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
