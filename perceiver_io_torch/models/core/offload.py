"""Activation offloading: the checkpointed layers' products without batch
dimensions saved in host memory.

The port's counterpart of the JAX package's
``jax.checkpoint_policies.offload_dot_with_no_batch_dims("device",
"pinned_host")`` (``perceiver_io_tpu/models/core/modules.py:_remat_policy``):
what ``dots_with_no_batch_dims_saveable`` keeps (the Dense layers' ``mm`` and
``addmm`` outputs) goes to host memory during the forward and comes back for
the backward's recompute; everything else is recomputed.

``torch.utils.checkpoint`` has no such policy, so ``context_fn`` returns a
pair of dispatch modes sharing one ``_Store`` a checkpointed call:

- the forward's ``_Offload`` runs every op and copies each ``mm``/``addmm``
  output into a host buffer. On the card the copy runs on a side stream of
  the output's device after an event on the current stream, and the output
  is ``record_stream``-ed on the side stream, so its block is not reused
  before the copy has read it;
- the recompute's ``_Restore`` runs every other op and answers each
  ``mm``/``addmm`` in call order with the host copy, moved back on the
  current stream after the side stream's copy event.

Host buffers come from ``POOL``, a process-wide pool keyed by element count
and dtype that later steps reuse; on the card they are page-locked
(``cudaHostRegister`` of an exactly sized host tensor). A buffer goes back to
the pool once its copy to the device is queued, with an event the next
forward copy into it waits for. A recompute that stops early (non-reentrant
checkpoint stops once it has what the backward needs) returns its unread
buffers when its store is collected. On the CPU the same code keeps plain
host copies. ``STATS`` counts the bytes moved each way; ``POOL.nbytes`` is
what the pool holds.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the products without batch dimensions: the Dense layers' matrix products
# (F.linear reaches the dispatcher as mm or addmm)
NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

STATS = {"d2h_bytes": 0, "h2d_bytes": 0, "offloaded": 0, "restored": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def _host_empty(n: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """``n`` host elements, page-locked with ``pin`` (registered with
    ``cudaHostRegister``, exactly sized; the caching host allocator's pinned
    memory where registration fails)."""
    t = torch.empty(n, dtype=dtype)
    if not pin or not n:
        return t
    if int(torch.cuda.cudart().cudaHostRegister(t.data_ptr(), n * t.element_size(), 0)) == 0:
        return t
    return torch.empty(n, dtype=dtype, pin_memory=True)


class HostPool:
    """Free host buffers keyed by (elements, dtype, pinned), each with the
    event that its last read (a copy to the device) recorded, or None."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[Tuple, List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]] = {}
        self.nbytes = 0  # host bytes allocated, in use or free (page-locked on the card)

    def acquire(self, n: int, dtype: torch.dtype, pin: bool):
        key = (n, dtype, pin)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
        buf = _host_empty(n, dtype, pin)
        with self._lock:
            self.nbytes += buf.nbytes
        return buf, None

    def release(self, buf: torch.Tensor, read: Optional[torch.cuda.Event], pin: bool) -> None:
        with self._lock:
            self._free.setdefault((buf.numel(), buf.dtype, pin), []).append((buf, read))

    def clear(self) -> None:
        """Drop the free buffers (unregistering pinned ones)."""
        with self._lock:
            free = [(key, buf) for key, bufs in self._free.items() for buf, _ in bufs]
            self._free.clear()
            for (_, _, pin), buf in free:
                self.nbytes -= buf.nbytes
                if pin:
                    torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


POOL = HostPool()
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class _Store:
    """One checkpointed call's offloaded products, in call order."""

    def __init__(self):
        self.entries = deque()

    def put(self, out: torch.Tensor) -> None:
        pin = out.is_cuda
        buf, read = POOL.acquire(out.numel(), out.dtype, pin)
        if pin:
            side = _side_stream(out.device)
            side.wait_event(torch.cuda.current_stream(out.device).record_event())
            if read is not None:
                side.wait_event(read)  # the buffer's last copy to the device has read it
            with torch.cuda.stream(side):
                buf.copy_(out.reshape(-1), non_blocking=True)
                copied = side.record_event()
            out.record_stream(side)
        else:
            buf.copy_(out.reshape(-1))
            copied = None
        STATS["d2h_bytes"] += buf.nbytes
        STATS["offloaded"] += 1
        self.entries.append((buf, copied, out.shape, out.stride(), out.device))

    def take(self) -> torch.Tensor:
        buf, copied, shape, stride, device = self.entries.popleft()
        out = torch.empty_strided(shape, stride, dtype=buf.dtype, device=device)
        read = None
        if device.type == "cuda":
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            out.copy_(buf.view(shape), non_blocking=True)
            read = current.record_event()
        else:
            out.copy_(buf.view(shape))
        POOL.release(buf, read, device.type == "cuda")
        STATS["h2d_bytes"] += buf.nbytes
        STATS["restored"] += 1
        return out

    def __del__(self):
        for buf, copied, _, _, device in self.entries:
            POOL.release(buf, copied, device.type == "cuda")
        self.entries.clear()


class _Offload(TorchDispatchMode):
    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in NO_BATCH_DOTS:
            self.store.put(out)
        return out


class _Restore(TorchDispatchMode):
    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in NO_BATCH_DOTS:
            return self.store.take()
        return func(*args, **(kwargs or {}))


def offload_context_fn():
    """``torch.utils.checkpoint``'s ``context_fn`` for offloading: the
    (forward, recompute) modes over one fresh store."""
    store = _Store()
    return _Offload(store), _Restore(store)
