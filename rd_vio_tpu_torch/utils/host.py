"""Host <-> device transfers for the tracking pipeline.

`asnp` and `fetch` are blocking device->host copies. `fetch_async` starts the
copy of a whole result dict into pinned host memory without blocking and
records a CUDA event behind it; `.wait()` waits on that event only, so the
host consumes a frame's results while later frames are already queued on the
device. `to_device` is the matching host->device upload: from pageable memory
a CUDA copy would first wait for the whole stream, so it stages through
pinned memory and copies asynchronously.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def asnp(x, dtype=None) -> np.ndarray:
    """np.asarray that also accepts tensors on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype) if dtype is not None else np.asarray(x)


def fetch(tree):
    """Blocking device->host copy of a tensor, or a dict/list/tuple of them."""
    return _map(tree, lambda t: t.detach().cpu().numpy())


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Upload a host array without synchronising the device's stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class AsyncFetch:
    """A device->host copy started at construction on the current stream.

    CUDA tensors are copied into pinned buffers with `non_blocking=True` and
    a CUDA event is recorded after the copies; CPU tensors are cloned (the
    producer may reuse its buffers)."""

    def __init__(self, tree):
        self._event = None

        def start(t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                return buf
            return t.clone()

        self._host = _map(tree, start)
        if any(t.is_cuda for t in _leaves(tree)):
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return _map(self._host, lambda t: t.numpy())


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


def fetch_async(tree) -> AsyncFetch:
    """Start fetching a tensor tree without blocking; .wait() yields numpy."""
    return AsyncFetch(tree)
