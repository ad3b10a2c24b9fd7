"""Host-side prefetching for training input pipelines (a copy of
vlaser_tpu/data/prefetch.py, standard library only).

The heavy host work (PIL decode, tiling, tokenization, packing) runs in
background threads that fill a bounded queue while the device runs the
previous step; the queue holds host numpy only, and the consumer moves a
batch to the device. PIL, numpy and tokenizers release the GIL for their
hot loops, so threads (not processes) are enough, and the dataset state
(the packing cursor) stays in-process for checkpoint and resume.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class PrefetchIterator:
    """Wrap a batch iterator with a background filler thread."""

    _SENTINEL = object()

    def __init__(self, batches: Iterator, buffer_size: int = 4,
                 num_threads: int = 1):
        self._source = batches
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        # a single filler preserves batch order (packing resume depends on
        # it); num_threads>1 uses a work-stealing pool over __getitem__-style
        # sources via map_prefetch below
        assert num_threads == 1, "use map_prefetch for parallel item loading"
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for b in self._source:
                if self._stop.is_set():
                    return
                self._q.put(b)
        except BaseException as e:  # surface in the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def map_prefetch(
    dataset,  # __len__/__getitem__ source (ConversationDataset etc.)
    indices: Iterator[int],
    collate: Callable,
    batch_size: int,
    num_threads: int = 4,
    buffer_batches: int = 4,
):
    """DataLoader-equivalent: N worker threads run dataset[i] (PIL/tokenize —
    GIL-released), the consumer collates in order.

    Yields collated batches following `indices` order exactly.
    """
    from concurrent.futures import ThreadPoolExecutor

    idx_iter = iter(indices)

    def gen():
        with ThreadPoolExecutor(num_threads) as pool:
            pending = []
            while True:
                while len(pending) < num_threads + batch_size:
                    try:
                        i = next(idx_iter)
                    except StopIteration:
                        break
                    pending.append(pool.submit(dataset.__getitem__, i))
                if len(pending) < batch_size:
                    if pending:
                        yield collate([f.result() for f in pending])
                    return
                chunk, pending = pending[:batch_size], pending[batch_size:]
                yield collate([f.result() for f in chunk])

    return PrefetchIterator(gen(), buffer_size=buffer_batches)
