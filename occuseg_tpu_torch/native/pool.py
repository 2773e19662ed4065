"""Multi-threaded host plan building (counterpart of
`occuseg_tpu/native/pool.py`).

`PlanPool` keeps a sliding window of batches whose host preparation runs in
worker threads and yields them in input order. Threads scale because the
planner's hot sections run outside the GIL: ctypes releases it for each
C++ call (voxelize, neighbour maps, downsample, chunk rulebooks), and the
NumPy glue releases it inside its large-array operations. The results
stay on the host as NumPy arrays (with `pin`, what the step uploads as CPU
tensors in page-locked memory, so that the upload neither stages through
pageable memory nor makes the host wait); only the caller's thread
uploads them to a device.

Unlike the JAX pool, each batch also gets its sorted point layout and its
per-point arrays permuted into it (`train.state.prepare_batch`): the
port's InputLayer needs the layout.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Tuple


class PlanPool:
    """Ordered sliding-window batch preparation over `workers` threads
    (one worker: a prefetch thread, the loop's `plan_prefetcher`), with up
    to `workers + 2` batches in flight."""

    def __init__(self, spec, workers: int, bucket_specs_list=None,
                 ns: int = 1, pin: bool = False, chunks: bool = True):
        self.workers = max(int(workers), 1)
        self.window = self.workers + 2
        self.spec = spec
        self.buckets = bucket_specs_list
        self.ns = ns
        self.pin = pin
        self.chunks = chunks
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="plan")

    def _build(self, batch: Dict) -> Tuple[Dict, object, int]:
        """(laid-out batch, host plan, bucket index) of one batch: the
        blocked layout for ns > 1, at the smallest cap bucket that fits
        with `bucket_specs_list`, chunk rulebooks with `chunks` (the
        training CLI's --chunk_conv), what the step uploads pinned with
        `pin` (`train.state.pinned`). Runs in a worker thread."""
        from occuseg_tpu_torch.train.bucketing import prepare_bucketed
        from occuseg_tpu_torch.train.state import pinned, prepare_batch
        if self.buckets is not None:
            laid, plan, bi = prepare_bucketed(batch, self.buckets, self.ns,
                                              self.chunks)
        else:
            (laid, plan), bi = prepare_batch(batch, self.spec, self.ns,
                                             self.chunks), 0
        return (*pinned(laid, plan), bi) if self.pin else (laid, plan, bi)

    def imap(self, batches: Iterable[Dict]
             ) -> Iterator[Tuple[Dict, object, int]]:
        """Yield (batch, host plan, bucket index) in input order, keeping
        up to `window` batches in flight."""
        pending: deque = deque()
        it = iter(batches)
        exhausted = False
        while True:
            while not exhausted and len(pending) < self.window:
                try:
                    b = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(self._pool.submit(self._build, b))
            if not pending:
                break
            yield pending.popleft().result()

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

