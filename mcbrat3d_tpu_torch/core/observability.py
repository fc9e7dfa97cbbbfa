"""Tracing, profiling, memory and logging utilities (PyTorch port).

Counterpart of ``mcbrat3d_tpu.core.observability`` and of the reference's
observability kit: its TAU selective instrumentation becomes a
``torch.profiler`` trace (reference: Makefile:43-55 'tau' compiler
personality); the coarse setup/total CPU timers become phase timers
(reference: Drivers/monteCarloDriver.f95:634-642,1180-1185); the
``memcheck`` RSS probe reading /proc/self/statm is reproduced and extended
with the CUDA devices' memory (reference: src/ErrorMessages.f95:92-101).
Nothing on the main path calls these yet.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from mcbrat3d_tpu_torch.core.device import resolve

logger = logging.getLogger("mcbrat3d_tpu_torch")


def memcheck_rss_kb() -> int:
    """Resident set size in kB from /proc/self/statm, -1 where it cannot
    be read (reference: ErrorMessages.f95:92-101 memcheck)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE") // 1024
    except (OSError, ValueError, IndexError):
        return -1


def device_memory_stats() -> dict:
    """Memory of every visible CUDA device, keyed by ``cuda:<i>``: the
    device's free and total bytes (``torch.cuda.mem_get_info``) and this
    process's allocated and peak-allocated bytes
    (``torch.cuda.memory_stats``). Raises where there is no CUDA device."""
    resolve("cuda")
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "name": torch.cuda.get_device_name(i),
            "free_bytes": int(free),
            "total_bytes": int(total),
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        }
    return out


class PhaseTimers:
    """Named wall-clock phase timers ('Setup CPU time' / 'Total CPU time'
    equivalents; reference: Drivers/monteCarloDriver.f95:634-642). Work
    queued on a CUDA device is not waited for: synchronize inside the
    phase to charge it its device time."""

    def __init__(self):
        self.totals: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.3f} s" for k, v in self.totals.items())


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the code region (the TAU
    equivalent): host activity and, where a card is present, the CUDA
    activity (kernel launches and their device time). On exit the trace
    is written to ``log_dir/trace.json`` in Chrome's trace format
    (chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the time by name."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def configure_logging(level=logging.INFO, master_only: bool = True):
    """Structured logging; with ``torch.distributed`` initialized only
    rank 0 emits below ERROR by default (the reference gates PRINTs on
    MasterProc)."""
    import torch.distributed as dist

    if (master_only and dist.is_available() and dist.is_initialized()
            and dist.get_rank() != 0):
        level = logging.ERROR
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s"))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    return logger
