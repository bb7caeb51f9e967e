"""Infinite batch loader with a pinned-memory prefetch to the card
(counterpart: ``diff3d_tpu/data/loader.py``).

  * :class:`InfiniteLoader` draws global batch ``n`` as a pure function of
    ``(seed, n)``: one ``SeedSequence(entropy=seed, spawn_key=(n,))``
    spawned once per slot picks each slot's object and views, so resume
    seeks to any step by number (``start_step``) with no loader state.  A
    thread pool overlaps sample decoding.
  * :func:`prefetch_to_device` runs the loader in a background thread,
    ``depth`` batches ahead: each batch is copied into pinned host memory
    and sent to the card with ``non_blocking=True`` on a side CUDA stream;
    the consumer's stream waits on that copy's event (in place of the JAX
    package's ``jax.device_put`` prefetch, ``loader.py:158``).

The per-host slicing and the ``permute`` sample mode (val loaders) wait
for the data-parallel and evaluation slices.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from diff3d_tpu_torch.data.images import quantize_uint8


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class InfiniteLoader:
    """Yields ``{'imgs': [B, V, H, W, 3], 'R': [B, V, 3, 3], 'T': [B, V, 3],
    'K': [B, 3, 3]}`` numpy batches forever (``imgs`` uint8); batch ``n``
    depends on ``(seed, n)`` only."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 num_workers: int = 8, start_step: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._step = start_step
        self._quant_warn: Dict[str, bool] = {}
        self._pool = (ThreadPoolExecutor(num_workers)
                      if num_workers > 0 else None)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch ``step``."""
        root = np.random.SeedSequence(entropy=self.seed, spawn_key=(step,))
        seqs = root.spawn(self.batch_size)
        n = len(self.dataset)

        def one(seq):
            rng = np.random.default_rng(seq)
            s = self.dataset.sample(int(rng.integers(n)), rng)
            if s["imgs"].dtype != np.uint8:
                s = dict(s, imgs=quantize_uint8(s["imgs"], self._quant_warn))
            return s

        if self._pool is not None:
            samples = list(self._pool.map(one, seqs))
        else:
            samples = [one(q) for q in seqs]
        return _collate(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch(self._step)
        self._step += 1
        return batch

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _Prefetcher:
    """The consumer side of :func:`prefetch_to_device`."""

    _END = object()

    def __init__(self, it: Iterator, device: torch.device, depth: int):
        self._it = it
        self._device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: list = []
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in batch.items()}
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        tensors = {k: t.pin_memory().to(self._device,
                                                        non_blocking=True)
                                   for k, t in tensors.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                if not self._put((tensors, event)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._error.append(e)
        finally:
            self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._END:
            if self._error:
                raise self._error[0]
            raise StopIteration
        tensors, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in tensors.values():
                # Made on the side stream, used on this one: keep the
                # allocator from reusing the block before this stream is
                # done with it.
                t.record_stream(current)
        return tensors

    def close(self) -> None:
        self._stop.set()
        while True:  # drain so the producer can observe the stop flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30)


def prefetch_to_device(it: Iterator,
                       device: Optional[Union[str, torch.device]] = None,
                       depth: int = 2) -> _Prefetcher:
    """Run ``it`` in a background thread, ``depth`` batches ahead, each
    batch a dict of tensors on ``device`` (the card unless another is
    named).  On the card the copy goes through pinned memory with
    ``non_blocking=True`` on a side stream."""
    from diff3d_tpu_torch.device import resolve_device

    return _Prefetcher(it, resolve_device(device), depth)
