"""``paddle.io``: datasets, samplers and the DataLoader (counterpart of
``paddle_tpu/io/__init__.py``).

``num_workers > 0`` starts real OS worker processes (fork, as the
reference does) that fetch and collate numpy batches and hand them to the
parent through POSIX shared memory. Two rules hold that the reference,
whose workers never touch an accelerator, does not need:

- the batches land on the device of the thread that called ``iter()``,
  captured there: the place is thread-local (``device/__init__.py``) and
  the single-process loader builds its batches in a producer thread,
  which would otherwise resolve a place of its own (the card, even after
  the caller's ``set_device("cpu")``);
- a forked worker never touches CUDA: before ``worker_init_fn`` it sets
  its own place to the CPU (so a dataset or transform that calls
  ``paddle.to_tensor`` makes a CPU tensor, where a forked child cannot
  start CUDA) and its torch to one thread, and whatever it returns
  crosses as numpy (a Tensor of bf16 as its exact f32 upcast). Only the
  parent moves a batch to the card.

float64 arrays arrive as float32, as in the reference.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as _mp
import os
import queue as _queue
import threading

import numpy as np
import torch

from .. import device as _device
from ..core.tensor import Tensor, _to_numpy


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(math.floor(n * f)) for f in lengths]
        counts[-1] += n - sum(counts)
        lengths = counts
    n = sum(lengths)
    perm = np.random.permutation(n).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset : offset + l]))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Sample randomly from a fixed subset of indices (io parity)."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        import numpy as np

        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _rank():
    """The process's rank: ``torch.distributed``'s when it is initialized,
    else ``PADDLE_TRAINER_ID`` or ``RANK``, else 0."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK", 0)))


def _world_size():
    """``torch.distributed``'s world size when it is initialized, else
    ``PADDLE_TRAINERS_NUM`` or ``WORLD_SIZE``, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM",
                              os.environ.get("WORLD_SIZE", 1)))


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler (parity: io/dataloader/batch_sampler.py)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else _world_size())
        self.local_rank = rank if rank is not None else _rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Samples -> one batch: numpy arrays and Python numbers stacked into
    Tensors on the current place, Tensors stacked, lists, tuples and dicts
    collated field by field."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return Tensor._wrap(_to_device(np.stack(batch),
                                       _device._current_device()))
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([s._data for s in batch]))
    if isinstance(sample, (int, np.integer)):
        return Tensor._wrap(_to_device(np.asarray(batch, dtype=np.int64),
                                       _device._current_device()))
    if isinstance(sample, (float, np.floating)):
        return Tensor._wrap(_to_device(np.asarray(batch, dtype=np.float32),
                                       _device._current_device()))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(fields)) for fields in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _to_device(arr, dev):
    """A numpy array as a torch tensor on ``dev`` (float64 as float32):
    one copy, host to host on the CPU and host to card on CUDA."""
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev, copy=True)


# --------------------------------------------------------------------------
# multiprocess workers + shared-memory transport
# --------------------------------------------------------------------------
def _collate_np(batch):
    """Worker-side collate: numpy only (workers never touch the card).
    Tensors (a transform's ``paddle.to_tensor``) stack as numpy, as the
    single-process collate stacks them; the reference's worker collate
    passes them through as a list."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (Tensor, torch.Tensor)):
        return np.stack([_tree_to_np(s) for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [
            _collate_np(list(fields)) for fields in zip(*batch)
        ]
    if isinstance(sample, dict):
        return {k: _collate_np([d[k] for d in batch]) for k in sample}
    return batch


def _tree_to_np(obj):
    """Normalize a collated pytree so it can ride shared memory: Tensors
    and torch tensors as numpy (the worker's are on the CPU)."""
    if isinstance(obj, Tensor):
        return _to_numpy(obj._data)
    if isinstance(obj, torch.Tensor):
        return _to_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return [_tree_to_np(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _tree_to_np(v) for k, v in obj.items()}
    return obj


def _flatten_arrays(obj, out):
    """Replace np arrays with {"@arr": i} markers, collecting them in out."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
        return {"@arr": len(out) - 1}
    if isinstance(obj, (list, tuple)):
        return [_flatten_arrays(o, out) for o in obj]
    if isinstance(obj, dict):
        return {k: _flatten_arrays(v, out) for k, v in obj.items()}
    return obj


def _unflatten_arrays(obj, arrays):
    if isinstance(obj, dict) and "@arr" in obj and len(obj) == 1:
        return arrays[obj["@arr"]]
    if isinstance(obj, list):
        return [_unflatten_arrays(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {k: _unflatten_arrays(v, arrays) for k, v in obj.items()}
    return obj


def _shm_pack(batch):
    """(structure, metas, shm_name|None): arrays concatenated into one
    SharedMemory segment; the structure references them by index."""
    from multiprocessing import shared_memory

    arrays = []
    struct = _flatten_arrays(batch, arrays)
    if not arrays:
        return struct, [], None
    total = sum(int(a.nbytes) for a in arrays)
    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    metas = []
    off = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        shm.buf[off:off + a.nbytes] = a.tobytes()
        metas.append((str(a.dtype), tuple(a.shape), off, int(a.nbytes)))
        off += a.nbytes
    name = shm.name
    # ownership transfers to the parent: without unregistering, the worker's
    # resource tracker unlinks the segment the moment the worker exits —
    # before the parent has read it
    from multiprocessing import resource_tracker

    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()  # segment persists until the parent unlinks it
    return struct, metas, name


def _shm_unpack(struct, metas, name, dev):
    """The batch of a shared-memory payload, its arrays as torch tensors on
    ``dev``, copied straight out of the segment; then the segment is
    unlinked."""
    from multiprocessing import shared_memory

    if name is None:
        return _np_tree_to_tensors(_unflatten_arrays(struct, []), dev)
    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = []
        for dtype, shape, off, nbytes in metas:
            view = np.frombuffer(shm.buf, dtype=np.dtype(dtype),
                                 count=nbytes // np.dtype(dtype).itemsize,
                                 offset=off).reshape(shape)
            arrays.append(Tensor._wrap(_to_device(view, dev)))
            # no view may outlive the segment's close()
            del view
        return _unflatten_arrays(struct, arrays)
    finally:
        shm.close()
        shm.unlink()


def _safe_put(result_q, stop_evt, tag, payload):
    """Deliver unless the parent asked for shutdown; on abort, unlink the
    payload's shm segment ourselves (the parent will never see it)."""
    while not stop_evt.is_set():
        try:
            result_q.put((tag, payload), timeout=0.2)
            return True
        except _queue.Full:
            continue
    _unlink_payload(payload)
    return False


def _worker_setup():
    """A forked worker's first act: its place is the CPU (a forked child
    cannot start CUDA) and its torch runs one thread, as torch's own
    DataLoader workers do."""
    _device.set_device("cpu")
    torch.set_num_threads(1)


def _worker_main(body, dataset, collate_fn, result_q, stop_evt, wid,
                 num_workers, worker_init_fn, use_shm, *args):
    """A forked worker of either pool: ``WorkerInfo``, the CPU place and
    one thread, ``worker_init_fn``, then ``body(dataset, emit, result_q,
    stop_evt, wid, *args)``, whose ``emit(tag, samples)`` collates to
    numpy and delivers through shared memory. An exception in the body
    reaches the parent with its traceback."""
    global _worker_ctx
    _worker_ctx = WorkerInfo(id=wid, num_workers=num_workers,
                             dataset=dataset)
    _worker_setup()
    if worker_init_fn is not None:
        worker_init_fn(wid)

    def emit(tag, samples):
        batch = _tree_to_np(
            collate_fn(samples) if collate_fn is not None
            else _collate_np(samples))
        payload = _shm_pack(batch) if use_shm else (batch, None, None)
        return _safe_put(result_q, stop_evt, tag, payload)

    try:
        body(dataset, emit, result_q, stop_evt, wid, *args)
    except KeyboardInterrupt:
        pass
    except Exception as e:  # surface the traceback to the parent
        import traceback

        result_q.put(("error", (wid, f"{e}\n{traceback.format_exc()}", None)))


def _map_body(dataset, emit, result_q, stop_evt, wid, index_q):
    """Map-style worker: fetch the index batches it is sent until ``None``."""
    while not stop_evt.is_set():
        try:
            item = index_q.get(timeout=0.2)
        except _queue.Empty:
            continue
        if item is None:
            return
        bidx, idxs = item
        if not emit(bidx, [dataset[i] for i in idxs]):
            return


def _iterable_body(dataset, emit, result_q, stop_evt, wid, batch_size,
                   drop_last):
    """Iterable-dataset worker: every worker consumes the FULL stream
    (reference worker semantics — shard inside the dataset via
    get_worker_info(), else data duplicates across workers), then sends
    how many batches it made."""
    seq = 0
    batch = []
    for sample in dataset:
        if stop_evt.is_set():
            return
        batch.append(sample)
        if len(batch) == batch_size:
            if not emit(("b", wid, seq), batch):
                return
            seq += 1
            batch = []
    if batch and not drop_last:
        if not emit(("b", wid, seq), batch):
            return
        seq += 1
    _safe_put(result_q, stop_evt, ("end", wid, seq), (None, None, None))


class _WorkerPool:
    """Parent side of a forked worker pool: start the workers on ``body``,
    take their results (raising if one raised or died), shut them down
    without leaking shared memory. Batches are rebuilt on the device
    captured when the pool started."""

    def __init__(self, loader, body, *args):
        self.loader = loader
        self._dev = _device._current_device()
        ctx = _mp.get_context("fork")
        self._stop = ctx.Event()
        self._result_q = ctx.Queue(
            maxsize=max(2, loader.prefetch_factor) * loader.num_workers)
        self._buffer = {}
        self._workers = []
        for w in range(loader.num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(body, loader.dataset, loader.collate_fn,
                      self._result_q, self._stop, w, loader.num_workers,
                      loader.worker_init_fn, loader.use_shared_memory,
                      *args),
                daemon=True,
            )
            p.start()
            self._workers.append(p)

    def _take(self, finished=()):
        """The next ``(tag, payload)`` from any worker. A worker that
        raised, or that died while not in ``finished``, stops the pool."""
        while True:
            try:
                tag, payload = self._result_q.get(timeout=5.0)
            except _queue.Empty:
                dead = [i for i, p in enumerate(self._workers)
                        if not p.is_alive() and i not in finished]
                if dead and self._result_q.empty():
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} exited unexpectedly")
                continue
            if tag == "error":
                wid, tb, _ = payload
                self._shutdown()
                raise RuntimeError(f"DataLoader worker {wid} raised:\n{tb}")
            return tag, payload

    def _shutdown(self):
        _pool_shutdown(self._stop, self._workers, self._result_q,
                       self._buffer)
        self._workers = []
        self._buffer = {}

    def close(self):
        self._shutdown()

    def __iter__(self):
        return self

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


class _MultiprocessIter(_WorkerPool):
    """Map-style pool: dispatch index batches round-robin, reorder results,
    rebuild device tensors from shm payloads."""

    def __init__(self, loader):
        index_q = _mp.get_context("fork").Queue()
        super().__init__(loader, _map_body, index_q)
        self._batches = list(loader.batch_sampler)
        self._n = len(self._batches)
        self._next = 0
        for bidx, idxs in enumerate(self._batches):
            index_q.put((bidx, list(idxs)))
        for _ in self._workers:
            index_q.put(None)

    def __next__(self):
        if self._next >= self._n:
            self._shutdown()
            raise StopIteration
        while self._next not in self._buffer:
            bidx, payload = self._take()
            self._buffer[bidx] = payload
        struct, metas, name = self._buffer.pop(self._next)
        self._next += 1
        return _shm_unpack(struct, metas, name, self._dev)


def _unlink_payload(payload):
    from multiprocessing import shared_memory

    name = payload[2] if isinstance(payload, tuple) and len(payload) == 3 \
        else None
    if isinstance(name, str):
        try:
            seg = shared_memory.SharedMemory(name=name)
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass


def _pool_shutdown(stop_evt, workers, result_q, buffer):
    """Cooperative pool teardown with no shm leaks: signal stop, drain the
    queue (unlinking undelivered payloads) until workers exit, then reap."""
    import time as _time

    stop_evt.set()
    for payload in buffer.values():
        _unlink_payload(payload)
    deadline = _time.monotonic() + 5.0
    while _time.monotonic() < deadline:
        try:
            tag, payload = result_q.get(timeout=0.1)
            if tag != "error":
                _unlink_payload(payload)
            continue
        except (_queue.Empty, EOFError, OSError):
            pass
        if not any(p.is_alive() for p in workers):
            break
    # final sweep after all workers exited
    while True:
        try:
            tag, payload = result_q.get_nowait()
        except (_queue.Empty, EOFError, OSError):
            break
        if tag != "error":
            _unlink_payload(payload)
    for p in workers:
        if p.is_alive():
            p.terminate()
        p.join(timeout=1.0)


class _MultiprocessIterableIter(_WorkerPool):
    """Worker pool over an IterableDataset: results interleaved round-robin
    across workers (w0.b0, w1.b0, w0.b1, ...)."""

    def __init__(self, loader):
        super().__init__(loader, _iterable_body, loader.batch_size,
                         loader.drop_last)
        self._ends = {}  # wid -> total batches produced
        self._cursor = [0] * loader.num_workers  # next seq per worker
        self._turn = 0

    def _advance_turn(self):
        n = len(self._cursor)
        for _ in range(n):
            self._turn = (self._turn + 1) % n
            w = self._turn
            if w not in self._ends or self._cursor[w] < self._ends[w]:
                return True
        return False

    def __next__(self):
        while True:
            w = self._turn
            if w in self._ends and self._cursor[w] >= self._ends[w]:
                # this worker is exhausted; find one that isn't
                if not self._advance_turn():
                    self._shutdown()
                    raise StopIteration
                continue
            want = ("b", w, self._cursor[w])
            if want in self._buffer:
                payload = self._buffer.pop(want)
                self._cursor[w] += 1
                self._advance_turn()
                return _shm_unpack(*payload, self._dev)
            tag, payload = self._take(finished=self._ends)
            if tag[0] == "end":
                self._ends[tag[1]] = tag[2]
            else:
                self._buffer[tag] = payload


def _np_tree_to_tensors(obj, dev):
    if isinstance(obj, np.ndarray):
        return Tensor._wrap(_to_device(obj, dev))
    if isinstance(obj, list):
        return [_np_tree_to_tensors(o, dev) for o in obj]
    if isinstance(obj, dict):
        return {k: _np_tree_to_tensors(v, dev) for k, v in obj.items()}
    return obj


class _DataLoaderIter:
    """The single-process iterator: each batch is fetched and collated with
    this thread's place set to the device captured when the iterator was
    made, in the producer thread when ``prefetch_factor > 0``."""

    def __init__(self, loader):
        self.loader = loader
        self._dev = _device._current_device()
        self._iter = self._make_gen()
        if loader.prefetch_factor > 0:
            self._q = _queue.Queue(maxsize=loader.prefetch_factor)
            self._done = object()
            self._error = None
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        else:
            self._q = None

    def _make_gen(self):
        loader = self.loader
        collate = loader.collate_fn or default_collate_fn
        ds = loader.dataset
        dev = self._dev
        if isinstance(ds, IterableDataset):
            def gen():
                batch = []
                samples = iter(ds)
                while True:
                    with _device._place_scope(dev):
                        sample = next(samples, _END)
                        if sample is _END:
                            break
                        batch.append(sample)
                        if len(batch) < loader.batch_size:
                            continue
                        out = collate(batch)
                    batch = []
                    yield out
                if batch and not loader.drop_last:
                    with _device._place_scope(dev):
                        out = collate(batch)
                    yield out

            return gen()

        def gen():
            for idx_batch in loader.batch_sampler:
                with _device._place_scope(dev):
                    out = collate([ds[i] for i in idx_batch])
                yield out

        return gen()

    def _producer(self):
        try:
            for item in self._iter:
                self._q.put(item)
        except BaseException as e:  # surfaces in the consumer's __next__
            self._error = e
        finally:
            self._q.put(self._done)

    def __next__(self):
        if self._q is None:
            return next(self._iter)
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def __iter__(self):
        return self


_END = object()


class DataLoader:
    def __init__(
        self,
        dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler=None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn=None,
        num_workers=0,
        use_buffer_reader=True,
        prefetch_factor=2,
        use_shared_memory=True,
        timeout=0,
        worker_init_fn=None,
        persistent_workers=False,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.prefetch_factor = prefetch_factor if use_buffer_reader else 0
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif not isinstance(dataset, IterableDataset):
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def __iter__(self):
        if self.num_workers > 0:
            if self.batch_sampler is not None:
                return _MultiprocessIter(self)
            return _MultiprocessIterableIter(self)
        return _DataLoaderIter(self)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("IterableDataset DataLoader has no len()")


class WorkerInfo:
    """Visible inside worker processes via get_worker_info()
    (parity: io/dataloader/worker.py WorkerInfo)."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_ctx = None  # set by _worker_main inside each worker process


def get_worker_info():
    return _worker_ctx
