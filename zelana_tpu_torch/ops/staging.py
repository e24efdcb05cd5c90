"""Host <-> card copies that overlap the kernels.

Uploads made on a worker thread, ordered before the kernels that read them:
the chunk pipeline stages chunk k+1's inputs (witness-map words, MSM
schedules) on a worker thread while chunk k's kernels run. On the card the
worker uploads on a side stream, so the copies overlap the main stream's
kernels instead of queueing behind them; the side stream then records an
event. Before the main thread launches a kernel that reads the staged
tensors, ``take_over`` makes its stream wait on that event and marks each
tensor as used by that stream (``record_stream``), so the caching allocator
does not hand the memory back to the side stream while the main stream
still reads it. On the CPU all three are no-ops.

``upload`` makes one pinned copy on the current stream (the tape MSM's
tape).

Downloads: ``download`` starts a non_blocking copy into pinned memory and
records an event, and ``fetch`` waits for it, so the host can go on
dispatching while a result streams back.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_SIDE: dict = {}
_LOCK = threading.Lock()


def side_stream(device: torch.device):
    """Context in which copies go to `device`'s upload stream."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    with _LOCK:
        key = str(device)
        if key not in _SIDE:
            _SIDE[key] = torch.cuda.Stream(device)
        return torch.cuda.stream(_SIDE[key])


def hand_over(tensors, device: torch.device):
    """Call inside side_stream after the uploads: (tensors, event)."""
    if device.type != "cuda":
        return list(tensors), None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return list(tensors), done


def take_over(handle, device: torch.device) -> None:
    """Order the current stream after the uploads of `handle`."""
    tensors, done = handle
    if done is None:
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_event(done)
    for t in tensors:
        t.record_stream(cur)


def download(t: torch.Tensor):
    """Start the copy of int32 words `t` to the host; a handle for fetch."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def fetch(handle) -> np.ndarray:
    """Wait for a download; its uint32 numpy words."""
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.detach().contiguous().numpy().view(np.uint32)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host -> card copy of numpy `arr` through pinned memory, queued
    on the current stream; on the CPU the array's own tensor."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
