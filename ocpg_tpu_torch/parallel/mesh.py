"""Batch placement on the device: the single-device part of
``ocpg_tpu/parallel/mesh.py``.

``prefetch_to_mesh(iterator, device)`` is the counterpart of JAX's
double-buffered ``prefetch_to_mesh``: it yields ``(host_batch,
device_batch)`` with the next batch's host-to-device copy already started,
so the copy leaves the step's critical path, as pinned-memory copies under
the reference's torch DataLoader do.  On a CUDA device each array is copied
into pinned host memory and sent with an asynchronous copy on a side
stream; the consumer's stream waits on an event recorded after the copies
before it touches the batch, and every device tensor is marked as used on
the consumer's stream (``record_stream``), so the caching allocator does not
hand its memory out while the step still reads it.  Each pinned buffer is
kept until its copy has finished.  On the CPU the arrays become tensors
that share their memory.

The mesh itself (``create_mesh``, ``shard_batch``, ``replicate``) comes
with the multi-GPU port.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch


def _map_arrays(tree, fn: Callable):
    """``tree`` with every numpy array or tensor leaf replaced by ``fn(leaf)``
    (dicts and lists walked, other leaves kept)."""
    if isinstance(tree, Mapping):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_arrays(v, fn) for v in tree]
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_arrays(tree, out.append)
    return out


def prefetch_to_mesh(iterator: Iterable, device: Union[str, torch.device] = "cuda",
                     size: int = 2) -> Iterator[Tuple[dict, dict]]:
    """Yields ``(host_batch, device_batch)``, ``size - 1`` batches' copies
    started ahead of the one yielded (see the module docstring)."""
    device = torch.device(device)
    if device.type != "cuda":
        buf = deque()
        for batch in iterator:
            buf.append((batch, _map_arrays(batch, lambda x: torch.as_tensor(x).to(device))))
            if len(buf) >= size:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
        return

    side = torch.cuda.Stream(device)
    consumer = torch.cuda.current_stream(device)
    pending = deque()

    def send(batch):
        pinned: List[torch.Tensor] = []

        def copy(x):
            host = torch.as_tensor(x).pin_memory()
            pinned.append(host)
            return host.to(device, non_blocking=True)

        with torch.cuda.stream(side):
            dev = _map_arrays(batch, copy)
            done = torch.cuda.Event()
            done.record(side)
        pending.append((batch, dev, pinned, done))

    def hand_over():
        batch, dev, pinned, done = pending.popleft()
        consumer.wait_event(done)
        for t in _tensors(dev):
            t.record_stream(consumer)
        yield batch, dev
        done.synchronize()          # the pinned buffers may go now
        del pinned

    for batch in iterator:
        send(batch)
        if len(pending) >= size:
            yield from hand_over()
    while pending:
        yield from hand_over()
