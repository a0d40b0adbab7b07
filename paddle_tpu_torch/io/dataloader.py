"""DataLoader (port of ``paddle_tpu/io/dataloader.py``).

Batches come from a ``BatchSampler`` (or an ``IterableDataset`` in
``batch_size`` slices) through ``collate_fn``; ``default_collate_fn``
stacks samples into torch tensors on the CPU, as the reference's gives host
arrays, and the model moves them to its device. With ``num_workers > 0``
samples are fetched by worker processes (``use_shared_memory=True``, the
default) or by a thread pool, with a bounded prefetch of ``num_workers *
prefetch_factor`` batches, and delivered in the sampler's order.

Worker processes start by ``forkserver`` where the dataset, ``collate_fn``
and ``worker_init_fn`` pickle and a child can load them: forking a process
whose torch thread pools are running can deadlock the child. Elsewhere
(a ``__main__`` read from stdin, which a child cannot import) they fork.
Each worker runs torch on one intra-op thread. A result is pickled in the
worker, so an unpicklable one comes back as an error instead of a silent
hang. The parent checks at least every 5 s that its workers live and
raises when one died; with ``timeout`` it raises when a batch has not come
in that many seconds. Workers are told to stop, joined for 2 s and
terminated in a ``finally``, whichever way the iteration ends.
``get_worker_info()`` gives a worker its id, the worker count and the
dataset. With the monitor on, the consumer's wait a batch, the batch count
and the queue depth are recorded (``paddle_tpu_dataloader_*``), as in the
reference.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import pickle
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "get_worker_info"]

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id_, num_workers, dataset):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch: List[Any]):
    """Stack samples into batched CPU tensors: tensors and numpy arrays
    stacked, numbers as one tensor, strings as a list, dicts and sequences
    field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.floating, np.integer)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(f))
                            for f in zip(*batch))
    raise TypeError(f"batch data cannot be a {type(sample)}")


def _fetch(dataset, indices, collate_fn):
    return collate_fn([dataset[i] for i in indices])


def _worker_loop(dataset, index_q, result_q, collate_fn, init_fn, wid,
                 num_workers):
    """Pull index batches, fetch and collate, push pickled ``(batch_idx,
    result, error)``; errors travel as strings and the worker lives on."""
    def _err(bidx, e):
        result_q.put(pickle.dumps(
            (bidx, None, f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}")))

    torch.set_num_threads(1)
    _worker_info.info = WorkerInfo(wid, num_workers, dataset)
    try:
        if init_fn:
            init_fn(wid)
    except Exception as e:
        _err(None, e)
        return
    while True:
        item = index_q.get()
        if item is None:
            break
        bidx, indices = item
        try:
            result_q.put(pickle.dumps(
                (bidx, _fetch(dataset, indices, collate_fn), None)))
        except Exception as e:
            _err(bidx, e)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        from .. import monitor

        self._monitor_id = monitor.instance_label("loader")
        self.dataset = dataset
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = bool(use_shared_memory)
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode or (batch_sampler is None
                                   and batch_size is None):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._instrument(self._iter_iterable())
        if self.batch_sampler is None:        # batch_size=None: one by one
            return self._instrument(
                self.collate_fn([self.dataset[i]])
                for i in range(len(self.dataset)))
        if self.num_workers == 0:
            return self._instrument(self._iter_single())
        if self.use_shared_memory:
            return self._instrument(self._iter_processes())
        return self._instrument(self._iter_workers())

    def __call__(self):
        return self.__iter__()

    # -- the monitor ----------------------------------------------------------
    @staticmethod
    def _depth_metric():
        from .. import monitor

        return monitor.gauge(
            "paddle_tpu_dataloader_queue_depth",
            "prefetched batches in flight (producer lead over the "
            "consumer) per live loader", ("loader",))

    def _depth_gauge(self):
        from .. import monitor

        if not monitor.enabled():
            return None
        return self._depth_metric().labels(loader=self._monitor_id)

    def _retire_depth_gauge(self, depth):
        if depth is not None:
            self._depth_metric().remove(loader=self._monitor_id)

    def _instrument(self, it):
        """With the monitor on, the time blocked in ``next()`` (the step's
        input starvation) and the batches delivered."""
        from .. import monitor

        if not monitor.enabled():
            return it
        wait = monitor.histogram(
            "paddle_tpu_dataloader_wait_seconds",
            "time the consumer blocked waiting for the next batch "
            "(input-pipeline starvation)")
        batches = monitor.counter(
            "paddle_tpu_dataloader_batches_total",
            "batches delivered by DataLoader iterators")

        def gen():
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                wait.observe(time.perf_counter() - t0)
                batches.inc()
                yield batch

        return gen()

    # -- the iterators --------------------------------------------------------
    def _iter_single(self):
        for indices in self.batch_sampler:
            yield _fetch(self.dataset, indices, self.collate_fn)

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch or (len(batch) < self.batch_size
                             and self.drop_last):
                return
            yield self.collate_fn(batch)

    def _iter_workers(self):
        """Thread workers with a bounded prefetch, delivered in order."""
        max_inflight = self.num_workers * self.prefetch_factor
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        if self.worker_init_fn:
            for i in range(self.num_workers):
                pool.submit(self.worker_init_fn, i)
        indices_iter = iter(self.batch_sampler)
        futures: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def submitter():
            for indices in indices_iter:
                if stop.is_set():
                    break
                while futures.qsize() >= max_inflight and not stop.is_set():
                    stop.wait(0.001)
                futures.put(pool.submit(_fetch, self.dataset, indices,
                                        self.collate_fn))
            futures.put(None)

        depth = self._depth_gauge()
        t = threading.Thread(target=submitter, daemon=True)
        t.start()
        try:
            while True:
                if depth is not None:
                    depth.set(futures.qsize())
                fut = futures.get()
                if fut is None:
                    return
                yield fut.result()
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            self._retire_depth_gauge(depth)

    def _start_method(self) -> str:
        """``forkserver`` where the worker's arguments pickle and a child
        can load them: ``__main__`` is a file or module its children
        import, or nothing pickled refers to ``__main__`` (a REPL's or a
        ``-c`` program's classes exist in the parent only). Else
        ``fork``."""
        cached = getattr(self, "_start_method_cache", None)
        if cached is not None:
            return cached
        main = sys.modules.get("__main__")
        mfile = getattr(main, "__file__", None)
        if getattr(main, "__spec__", None) is not None or (
                mfile and os.path.exists(mfile)):
            loadable = True           # the children import __main__
        elif mfile is None:
            loadable = None           # nothing to import, nothing of it
        else:
            loadable = False          # "<stdin>": a child would die on it
        try:
            payload = pickle.dumps((self.dataset, self.collate_fn,
                                    self.worker_init_fn))
        except Exception:
            payload = None
        method = "fork"
        if payload is not None and (loadable or (
                loadable is None and b"__main__" not in payload)):
            method = "forkserver"
        self._start_method_cache = method
        return method

    def _iter_processes(self):
        """Worker processes over one index queue; results come back as
        ``(batch_idx, data, err)`` and a reorder buffer restores the
        sampler's order."""
        method = self._start_method()
        ctx = mp.get_context(method)
        if method == "forkserver":
            # the server would otherwise import __main__, rerunning an
            # unguarded training script
            ctx.set_forkserver_preload([])
        index_q, result_q = ctx.Queue(), ctx.Queue()
        workers = [ctx.Process(target=_worker_loop,
                               args=(self.dataset, index_q, result_q,
                                     self.collate_fn, self.worker_init_fn, i,
                                     self.num_workers), daemon=True)
                   for i in range(self.num_workers)]
        max_inflight = self.num_workers * self.prefetch_factor
        indices_iter = enumerate(iter(self.batch_sampler))
        sent = 0
        done_sending = False

        def send_one():
            nonlocal sent, done_sending
            try:
                bidx, indices = next(indices_iter)
            except StopIteration:
                done_sending = True
                return
            index_q.put((bidx, list(indices)))
            sent += 1

        depth = self._depth_gauge()
        try:
            for w in workers:
                w.start()
            for _ in range(max_inflight):
                if done_sending:
                    break
                send_one()
            reorder = {}
            nxt = 0
            waited = 0.0
            while nxt < sent or not done_sending:
                if depth is not None:
                    depth.set(sent - nxt)
                if nxt in reorder:
                    data, err = reorder.pop(nxt)
                else:
                    poll = 5.0 if not self.timeout else max(
                        0.01, min(5.0, self.timeout - waited))
                    try:
                        bidx, data, err = pickle.loads(result_q.get(
                            timeout=poll))
                    except queue.Empty:
                        waited += poll
                        if not all(w.is_alive() for w in workers):
                            raise RuntimeError(
                                "DataLoader worker died unexpectedly "
                                "(killed / segfault); restart the loader")
                        if self.timeout and waited >= self.timeout:
                            raise RuntimeError(
                                f"DataLoader worker timed out after "
                                f"{self.timeout}s (batch {nxt})")
                        continue
                    waited = 0.0
                    if bidx is None:
                        raise RuntimeError(
                            f"DataLoader worker_init_fn raised:\n{err}")
                    if bidx != nxt:
                        reorder[bidx] = (data, err)
                        continue
                if err is not None:
                    raise RuntimeError(f"DataLoader worker raised:\n{err}")
                if not done_sending:
                    send_one()
                yield data
                nxt += 1
        finally:
            for _ in workers:
                index_q.put(None)
            for w in workers:
                if w.pid is not None:
                    w.join(timeout=2)
                    if w.is_alive():
                        w.terminate()
                        w.join(timeout=2)
            for q_ in (index_q, result_q):
                q_.cancel_join_thread()
                q_.close()
            self._retire_depth_gauge(depth)
