"""Input pipeline: threaded host prefetch, as `voxelnet_tpu/data/pipeline.py`
(`PrefetchIterator`, `LazyBatchIterator`), plus `LazyBatchIterator.close`
so a consumer that stops mid-epoch leaves no worker blocked on its output
queue. Staging onto the card is the trainer's (training/trainer.py).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

from voxelnet_tpu_torch.data.dataset import collate, plan_batches


class PrefetchIterator:
    """Run a source iterator in one background thread, keeping up to
    `depth` items ready, in order."""

    _DONE = object()

    def __init__(self, make_iterator: Callable[[], Iterator[dict]],
                 depth: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None
        self._thread = threading.Thread(
            target=self._produce, args=(make_iterator(),), daemon=True)
        self._thread.start()

    def _produce(self, source):
        try:
            for item in source:
                self._queue.put(item)
        except Exception as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class LazyBatchIterator:
    """Assemble batches in `workers` background threads, in a deterministic
    order: workers tag each batch with its sequence number and the consumer
    reorders, so any worker count gives the same batch stream (on top of
    the dataset's per-(item, epoch) RNG). numpy releases the GIL for the
    heavy parts (file IO, gathers, padding). `process_shard` is
    plan_batches' per-process loading by data index."""

    _DONE = object()

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, workers: int = 4, depth: int = 8,
                 drop_remainder: bool = True,
                 transform: Callable[[dict], dict] | None = None,
                 process_shard: tuple[int, int] | None = None):
        self._transform = transform
        chunks = [idxs for idxs, _ in plan_batches(
            len(dataset), batch_size, shuffle, seed, drop_remainder,
            process_shard)]
        self._dataset = dataset
        self._work: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None
        for seq, c in enumerate(chunks):
            self._work.put((seq, c))
        workers = max(1, min(workers, len(chunks) or 1))
        for _ in range(workers):
            self._work.put(self._DONE)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"batch-worker-{i}")
            for i in range(workers)]
        for t in self._threads:
            t.start()
        self._live = workers
        self._next_seq = 0
        self._pending: dict[int, dict] = {}

    def _worker(self):
        try:
            while True:
                item = self._work.get()
                if item is self._DONE:
                    break
                seq, idxs = item
                batch = collate([self._dataset[int(i)] for i in idxs])
                if self._transform is not None:
                    batch = self._transform(batch)
                self._out.put((seq, batch))
        except Exception as e:
            self._error = e
        finally:
            self._out.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        # Drain completions into the reorder buffer until the next batch in
        # sequence is there. The buffer is the consumer's and unbounded, so
        # workers never block on out-of-order completions.
        while True:
            if self._next_seq in self._pending:
                batch = self._pending.pop(self._next_seq)
                self._next_seq += 1
                return batch
            if self._live <= 0:
                if self._error is not None:
                    raise self._error
                raise StopIteration
            item = self._out.get()
            if item is self._DONE:
                self._live -= 1
                if self._error is not None:
                    # fail fast: stop the surviving workers instead of
                    # loading the rest of the epoch behind the error
                    self.close()
                    raise self._error
                continue
            seq, batch = item
            self._pending[seq] = batch

    def close(self, timeout: float = 5.0) -> None:
        """Stop the workers: drop the queued work and drain the output
        queue until every worker has exited, or `timeout` seconds have
        passed (a worker stuck in dataset IO stays a daemon thread).
        Idempotent."""
        try:
            while True:
                self._work.get_nowait()
        except queue.Empty:
            pass
        for _ in self._threads:
            self._work.put(self._DONE)      # release workers waiting for work
        # a worker blocked on the full output queue never reaches
        # _work.get(): each drained slot unblocks one put, the final _DONE
        # put of each worker included
        deadline = time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    self._out.get(timeout=0.05)
                except queue.Empty:
                    pass
                t.join(timeout=0.02)
        self._live = 0
        self._pending.clear()
