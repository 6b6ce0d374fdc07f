"""Host batching: samplers, collation, parallel collate + prefetch.

Replaces the reference's torch DataLoader + multi-worker setup
(reference: src/data_loader_manager/data_loader_vqa2.py:521-564) with a
plain iterator. With ``num_workers <= 1`` a single background thread
pipelines host-side collation (tokenization, numpy assembly) with device
compute; with ``num_workers > 1`` a thread pool collates several batches
concurrently and yields them in order (HF fast tokenizers release the GIL
in their Rust core, so tokenization-heavy collate scales across threads
without fork workers — forking a process that holds a CUDA context is
unsafe).

For static device shapes the final partial batch is padded by repeating its
last sample; a boolean ``sample_valid`` mask marks the real rows so eval
code can drop padding predictions before the VQA protocol's full-coverage
check.

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/loader.py,
held against it by tests/test_torch_eval_data.py.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterator, List, Sequence

import numpy as np


class BatchIterator:
    """Iterates batches of collated samples with optional shuffling."""

    def __init__(
        self,
        dataset: Any,  # needs __len__ and __getitem__
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any],
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad_last_batch: bool = True,
        prefetch: int = 2,
        num_workers: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last_batch = pad_last_batch
        self.prefetch = prefetch
        self.num_workers = num_workers
        # multi-process data sharding: this iterator yields samples
        # [shard_id::num_shards] (after any shuffle), so the union over
        # shards is exactly the dataset — required by the VQA protocol's
        # full-coverage check after gather_predictions_to_host0
        if not (0 <= shard_id < num_shards):
            raise ValueError(
                f"shard_id {shard_id} out of range for {num_shards} shards"
            )
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffles per epoch deterministically (seed + epoch)."""
        self.epoch = epoch

    def _num_local(self) -> int:
        """Number of samples in this process's shard."""
        n = len(self.dataset)
        if self.num_shards <= 1:
            return n
        return len(range(self.shard_id, n, self.num_shards))

    def __len__(self) -> int:
        n = self._num_local()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        n = len(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_last_batch and len(idx) > 0:
                    pad = np.full(
                        self.batch_size - len(idx), idx[-1], dtype=idx.dtype
                    )
                    idx = np.concatenate([idx, pad])
            batches.append(idx)
        return batches

    def _make_batch(self, idx: np.ndarray, n_valid: int) -> Any:
        samples = [self.dataset[int(i)] for i in idx]
        batch = self.collate_fn(samples)
        valid = np.zeros(len(idx), dtype=bool)
        valid[:n_valid] = True
        try:
            batch["sample_valid"] = valid
        except TypeError:
            pass
        return batch

    def __iter__(self) -> Iterator[Any]:
        batches = self._index_batches()
        n = self._num_local()

        def n_valid(batch_i: int, idx: np.ndarray) -> int:
            remaining = n - batch_i * self.batch_size
            return min(len(idx), remaining)

        if self.prefetch <= 0:
            for i, idx in enumerate(batches):
                yield self._make_batch(idx, n_valid(i, idx))
            return

        if self.num_workers > 1:
            yield from self._iter_pool(batches, n_valid)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer() -> None:
            try:
                for i, idx in enumerate(batches):
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idx, n_valid(i, idx)))
                q.put(None)
            except BaseException as exc:  # surface worker errors to consumer
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)

    def _iter_pool(self, batches, n_valid) -> Iterator[Any]:
        """Pool collate: up to ``num_workers`` batches collated
        concurrently, yielded in order; in-flight futures bounded by
        ``num_workers + prefetch`` so memory stays flat."""
        from concurrent.futures import ThreadPoolExecutor

        window = self.num_workers + max(self.prefetch, 0)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "collections.deque" = collections.deque()
            it = enumerate(batches)
            try:
                for i, idx in it:
                    pending.append(
                        pool.submit(self._make_batch, idx, n_valid(i, idx))
                    )
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for fut in pending:
                    fut.cancel()


class ListDataset:
    """Minimal dataset over an in-memory list of samples."""

    def __init__(self, items: Sequence[Any]):
        self.items = list(items)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Any:
        return self.items[idx]
