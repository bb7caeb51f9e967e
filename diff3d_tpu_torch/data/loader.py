"""Infinite batch loader with a pinned-memory prefetch to the card
(counterpart: ``diff3d_tpu/data/loader.py``).

  * :class:`InfiniteLoader` draws global batch ``n`` as a pure function of
    ``(seed, n)``: one ``SeedSequence(entropy=seed, spawn_key=(n,))``
    spawned once per global slot picks each slot's object and views, so
    resume seeks to any step by number (``start_step``) with no loader
    state.  Rank ``r`` of ``n`` (``host_id`` / ``num_hosts``) takes slots
    ``[r B, r B + B)`` of that global batch, so any partition concatenates
    to the same global stream (an elastic re-mesh neither replays nor
    skips).  A thread pool overlaps sample decoding.
    ``sample_mode="permute"`` (the val loaders) takes the objects from
    per-epoch permutations instead.
  * :func:`prefetch_to_device` runs the loader in a background thread,
    ``depth`` batches ahead: each batch is copied into pinned host memory
    and sent to the card with ``non_blocking=True`` on a side CUDA stream;
    the consumer's stream waits on that copy's event (in place of the JAX
    package's ``jax.device_put`` prefetch, ``loader.py:158``).
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
    'K': [B, 3, 3]}`` numpy batches forever (``imgs`` uint8), ``B`` the
    per-rank batch; batch ``n`` depends on ``(seed, n)`` only, rank
    ``host_id`` taking global slots ``[host_id B, host_id B + B)`` of
    ``B * num_hosts``.

    ``sample_mode``: ``"iid"`` (training) draws each slot's object
    independently, with replacement; ``"permute"`` (the val loaders) reads
    draw ``g = n * global_batch + global_slot`` from a per-epoch
    permutation of the dataset (shared by every rank), so every object is
    seen once per ``len(dataset)`` consecutive draws, still a pure function
    of ``(seed, n, global_slot)``."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 num_workers: int = 8, start_step: int = 0,
                 sample_mode: str = "iid"):
        if sample_mode not in ("iid", "permute"):
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id={host_id} not in [0, {num_hosts})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.sample_mode = sample_mode
        self._step = start_step
        self._quant_warn: Dict[str, bool] = {}
        self._perm_cache: Dict[int, np.ndarray] = {}
        self._pool = (ThreadPoolExecutor(num_workers)
                      if num_workers > 0 else None)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        """The permutation of epoch ``epoch``: its own entropy
        ``(seed, 0x7065726D)``, disjoint from the per-slot streams, which
        spawn from ``entropy=seed``.  The last 4 epochs are kept."""
        perm = self._perm_cache.get(epoch)
        if perm is None:
            rng = np.random.default_rng(np.random.SeedSequence(
                entropy=(self.seed, 0x7065726D), spawn_key=(epoch,)))
            perm = rng.permutation(len(self.dataset))
            self._perm_cache[epoch] = perm
            for old in sorted(self._perm_cache)[:-4]:
                del self._perm_cache[old]
        return perm

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This rank's slots of global batch ``step``."""
        global_batch = self.batch_size * self.num_hosts
        lo = self.host_id * self.batch_size
        root = np.random.SeedSequence(entropy=self.seed, spawn_key=(step,))
        seqs = root.spawn(global_batch)[lo:lo + self.batch_size]
        n = len(self.dataset)
        if self.sample_mode == "permute":
            g0 = step * global_batch + lo
            idxs = [int(self._epoch_perm((g0 + b) // n)[(g0 + b) % n])
                    for b in range(self.batch_size)]
        else:
            idxs = [None] * self.batch_size

        def one(args):
            idx, seq = args
            rng = np.random.default_rng(seq)
            if idx is None:
                idx = int(rng.integers(n))
            s = self.dataset.sample(idx, rng)
            if s["imgs"].dtype != np.uint8:
                s = dict(s, imgs=quantize_uint8(s["imgs"], self._quant_warn))
            return s

        if self._pool is not None:
            samples = list(self._pool.map(one, zip(idxs, seqs)))
        else:
            samples = [one(a) for a in zip(idxs, seqs)]
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
