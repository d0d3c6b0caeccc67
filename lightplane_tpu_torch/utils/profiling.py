"""Device time and memory measurement (counterpart of
``lightplane_tpu/utils/profiling.py``): ``Timer`` on CUDA events where the
device is a GPU and on the host clock after a synchronise otherwise;
``device_memory_stats`` and ``Memory`` on ``torch.cuda``'s allocator
statistics.  The device is the caller's to name: the GPU unless given."""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

# Set LIGHTPLANE_PROFILE=1 to make Timer and Memory print on exit.
PROFILE = os.environ.get("LIGHTPLANE_PROFILE", "0") not in ("0", "", "false")


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


class Timer:
    """Context manager measuring the milliseconds of the work issued inside
    it on ``device``::

        with Timer("render") as t:
            out = render(...)
        print(t.ms)

    On a GPU two CUDA events on the current stream bracket the block, and
    the exit waits for the second; elsewhere the host clock, with the
    device synchronised at both ends."""

    def __init__(self, name: str = "", device="cuda"):
        self.name = name
        self.device = torch.device(device)
        self.ms: Optional[float] = None

    def __enter__(self):
        if _is_cuda(self.device):
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _is_cuda(self.device):
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        if PROFILE and self.name:
            print(f"[lightplane profile] {self.name}: {self.ms:.2f} ms")
        return False


def device_memory_stats(device="cuda") -> dict:
    """The allocator statistics of a GPU (``torch.cuda.memory_stats``),
    with the JAX package's names for the two it reads,
    ``bytes_in_use`` (``memory_allocated``) and ``peak_bytes_in_use``
    (``max_memory_allocated``); an empty dict for a device without them
    (the CPU)."""
    if not _is_cuda(device):
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = torch.cuda.memory_allocated(device)
    stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(device)
    return stats


class Memory:
    """Context manager reporting the change of allocated memory across the
    block (``delta_mb``) and the allocator's peak (``peak_mb``), both in
    MiB, where the device has allocator statistics (else ``None``)."""

    def __init__(self, name: str = "", device="cuda"):
        self.name = name
        self.device = torch.device(device)
        self.delta_mb: Optional[float] = None
        self.peak_mb: Optional[float] = None

    def __enter__(self):
        self._before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        if _is_cuda(self.device):
            torch.cuda.synchronize(self.device)
        after = device_memory_stats(self.device)
        if "bytes_in_use" in after and "bytes_in_use" in self._before:
            self.delta_mb = (after["bytes_in_use"]
                             - self._before["bytes_in_use"]) / 2**20
        if "peak_bytes_in_use" in after:
            self.peak_mb = after["peak_bytes_in_use"] / 2**20
        if PROFILE and self.name:
            print(f"[lightplane profile] {self.name}: "
                  f"delta {self.delta_mb} MB, peak {self.peak_mb} MB")
        return False
