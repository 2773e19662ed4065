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
port's InputLayer needs the layout. Under spatial sharding a batch keeps
its order and its plan is this rank's `ShardArgs` instead. Which of these
a batch gets is chosen once, when the pool is built
(`train.state.batch_preparation`).

Spans and counters (`utils/profiling.py`): `plan.batch`, each batch's
preparation on its worker (its children: `plan.host`, `plan.chunks`,
`plan.layout`, `plan.pin`); `pool.wait`, the time the consumer blocks on
the next batch; `pool.ready_at_take`, the batches of the window already
prepared when the consumer takes one (over the count of `plan.batch`:
the mean queue depth).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional, Tuple

from occuseg_tpu_torch.train.state import batch_preparation
from occuseg_tpu_torch.utils.profiling import count, span


def _set_threads(n: int) -> None:
    from occuseg_tpu_torch import native
    native.set_threads(n)


class PlanPool:
    """Ordered sliding-window batch preparation over `workers` threads
    (one worker: a prefetch thread, the loop's `plan_prefetcher`), with up
    to `workers + 2` batches in flight. The preparation's options are
    `train.state.batch_preparation`'s: the blocked layout of `ns` scenes,
    the smallest of `bucket_specs_list`'s cap buckets that fits, chunk
    rulebooks with `chunks` (the training CLI's --chunk_conv), pinned with
    `pin`, this rank's shard with `spatial`. With `threads`, each worker's
    OpenMP loops in the C++ planner start teams of that many threads
    (`native.set_threads`; ranks that share a host share its cores,
    `parallel/data_parallel.share_cores`); without, OpenMP's default
    (every core)."""

    def __init__(self, spec, workers: int, bucket_specs_list=None,
                 ns: int = 1, pin: bool = False, chunks: bool = True,
                 spatial=None, threads: Optional[int] = None):
        self.workers = max(int(workers), 1)
        self.window = self.workers + 2
        self.threads = threads
        self._prepare = batch_preparation(spec, bucket_specs_list, ns, pin,
                                          chunks, spatial)
        team = {} if threads is None else {
            "initializer": _set_threads, "initargs": (int(threads),)}
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="plan", **team)

    def _build(self, batch: Dict) -> Tuple[Dict, object, int]:
        """One batch's preparation, in a worker thread, as the span
        `plan.batch`."""
        with span("plan.batch"):
            return self._prepare(batch)

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
            count("pool.ready_at_take", sum(f.done() for f in pending))
            with span("pool.wait"):
                item = pending.popleft().result()
            yield item

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

