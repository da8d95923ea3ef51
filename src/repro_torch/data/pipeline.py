"""Host→device input pipeline: step-seeded prefetch, exact skip-ahead.

The port of the JAX package's ``data/pipeline.py``.  :class:`ShardedFeed`
turns a host-side numpy generator (``data/synthetic.py``) into tensors on
the device, with a background prefetch thread of bounded depth, so the
host never blocks the step on producing a batch.  For a CUDA device the
worker thread puts each batch into pinned host memory, and the consumer
copies it to the card without blocking, on its current stream: the copy
is queued behind the step that is running and the host goes on.

With a mesh (``launch.mesh``) each rank places only its block of the
batch: the leading dim cut over the data axes in mesh order
(:func:`batch_sharding`), as the reference lays a batch out over its
devices.  Every rank makes the same step-seeded batch and keeps its rows.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..runtime.sharding import shard_slice


def batch_sharding(mesh, ndim: int, data_axes=("pod", "data")) -> tuple:
    """The spec of an ``ndim`` batch array: dim 0 over the mesh's data
    axes, the rest replicated."""
    return (tuple(a for a in data_axes if a in mesh.axis_names),) \
        + (None,) * (ndim - 1)


def _rows(value, mesh) -> np.ndarray:
    """This rank's block of ``value``'s leading dim under
    :func:`batch_sharding`."""
    a = np.asarray(value)
    if mesh is None or a.ndim == 0:
        return a
    return shard_slice(torch.from_numpy(a), batch_sharding(mesh, a.ndim),
                       mesh).numpy()


def _host(value, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(value, order="C"))
    return t.pin_memory() if pin else t


def place(batch: dict, mesh=None, device=None) -> dict:
    """A batch of numpy arrays as tensors on ``device`` (the card unless
    the caller names another; a mesh's own device with a mesh), each cut
    to this rank's rows under a mesh.  On CUDA each array goes through
    pinned memory and is copied without blocking on the current stream."""
    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    pin = dev.type == "cuda"
    return {k: _host(_rows(v, mesh), pin).to(dev, non_blocking=pin)
            for k, v in batch.items()}


class ShardedFeed:
    """Prefetching iterator over step-seeded batches (this rank's rows of
    each under ``mesh``).

    ``batch_fn(step) -> dict of numpy``; a restart constructs the feed
    with ``start_step`` from the checkpoint (exact skip-ahead, no replay).
    At most ``depth`` batches wait in host memory (pinned for a CUDA
    device).  An exception raised by ``batch_fn`` is raised again by
    ``next``."""

    def __init__(self, batch_fn: Callable[[int], dict], mesh=None,
                 start_step: int = 0, depth: int = 2, device=None):
        self._fn = batch_fn
        self._mesh = mesh
        self._dev = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self._pin = self._dev.type == "cuda"
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, {k: _host(_rows(v, self._mesh), self._pin)
                               for k, v in self._fn(step).items()})
            except Exception as exc:       # handed to the consumer
                item = (step, exc)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        while True:
            try:
                step, batch = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                continue
            if isinstance(batch, Exception):
                raise batch
            if step < self._step:      # stale after a skip-ahead
                continue
            self._step = step + 1
            return {k: t.to(self._dev, non_blocking=self._pin)
                    for k, t in batch.items()}

    def close(self) -> None:
        """Stop the prefetch thread and wait for it (at most 5 s: it
        checks the stop flag every 0.5 s)."""
        self._stop.set()
        self._thread.join(5.0)
