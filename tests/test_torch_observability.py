"""PyTorch port: ``core/observability.py`` on the CPU.

The RSS probe, the phase timers, the CUDA memory stats (which raise where
there is no card), a ``torch.profiler`` trace exported in Chrome's format
that names the operations run inside it, and master-only logging under
``torch.distributed``.
"""

import json
import logging
import time

import pytest
import torch

from mcbrat3d_tpu_torch.core import observability as obs


def test_memcheck_and_phase_timers():
    assert obs.memcheck_rss_kb() > 1000
    t = obs.PhaseTimers()
    for _ in range(2):
        with t.phase("setup"):
            time.sleep(0.01)
    with t.phase("run"):
        pass
    assert t.totals["setup"] >= 0.02 and set(t.totals) == {"setup", "run"}
    assert t.report().splitlines()[0].startswith("setup: ")


def test_device_memory_stats_needs_a_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            obs.device_memory_stats()


def test_profiler_trace_names_the_work(tmp_path):
    a = torch.rand(64, 64)
    with obs.profiler_trace(str(tmp_path)) as prof:
        (a @ a).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "aten::mm" for ev in trace["traceEvents"])


def test_configure_logging_master_only(monkeypatch):
    import torch.distributed as dist

    assert obs.configure_logging().level == logging.INFO
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert obs.configure_logging().level == logging.ERROR
    assert obs.configure_logging(master_only=False).level == logging.INFO
