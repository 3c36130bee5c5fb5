"""Observability: structured metrics, profiling, debug toggles.

Counterpart of :mod:`pyhgt_tpu.train.log`:

- :class:`MetricsLogger` appends one JSON object per event to a .jsonl
  file (and optionally echoes to stdout);
- :func:`profile_trace` wraps a block in a ``torch.profiler`` trace and
  writes it as a Chrome trace;
- :func:`debug_nans` turns on autograd's anomaly detection in a context
  (a backward that produces NaN raises, naming the forward op);
- throughput counters (edges/s) are first-class fields.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

TRACE_FILE = "trace.json"


class MetricsLogger:
    """Append-only JSONL metrics sink with wall-clock stamping."""

    def __init__(self, path: Optional[str] = None, echo: bool = False) -> None:
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=float)
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        return rec

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Collect a ``torch.profiler`` trace of a block (host ops, and the
    device's kernels and copies when a GPU is present) and write it to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing,
    Perfetto). Yields the profiler, so the caller can also read
    ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Scoped autograd anomaly detection (``jax_debug_nans`` in the JAX
    package): inside, a backward that yields NaN raises with the forward
    op's traceback."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enabled)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)


def throughput(n_edges: int, n_layers: int, step_seconds: float) -> Dict[str, float]:
    """Train edges/s: each valid edge once per layer per step."""
    return {
        "edges_per_s": n_edges * n_layers / max(step_seconds, 1e-12),
        "step_ms": step_seconds * 1e3,
    }
