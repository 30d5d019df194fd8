"""``paddle.io`` and ``paddle.save``/``load`` of the port on the CPU.

The first six tests are ``tests/test_dataloader_mp.py``'s on the port's
``DataLoader``: real worker processes and the sampler's order, ``WorkerInfo``
and ``worker_init_fn``, a dead worker raises, a worker's exception
surfaces, an iterable dataset sharded through ``get_worker_info``, and
the workers' overlap. Then the samplers, ``random_split`` and the collate
against the JAX package's (the same ``np.random`` seed draws the same
orders), the loader's device capture (a prefetching loader builds its
batches in another thread, whose place is its own), a worker's CPU place,
and ``save``/``load`` round trips, bit for bit.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.io import (BatchSampler, DataLoader, Dataset,
                                 DistributedBatchSampler, IterableDataset,
                                 RandomSampler, SequenceSampler, Subset,
                                 TensorDataset, WeightedRandomSampler,
                                 default_collate_fn, get_worker_info,
                                 random_split)
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _mk_loader(ds, **kw):
    return DataLoader(ds, batch_size=4, shuffle=False, drop_last=False, **kw)


# -- the reference's six worker tests ---------------------------------------------
def test_workers_are_real_processes_and_order_preserved():
    from paddle_tpu_torch.io import _MultiprocessIter

    class DS(Dataset):
        def __getitem__(self, i):
            return np.full((3,), i, np.float32), {"pid": np.int64(os.getpid())}

        def __len__(self):
            return 16

    it = iter(_mk_loader(DS(), num_workers=2))
    assert isinstance(it, _MultiprocessIter)
    pids, seen = set(), []
    for feats, meta in it:
        seen.extend(feats.numpy()[:, 0].tolist())
        pids.update(meta["pid"].numpy().tolist())
    assert seen == list(range(16)), seen
    assert os.getpid() not in pids, "samples must be fetched in workers"
    assert len(pids) >= 1


def test_worker_info_and_init_fn():
    class DS(Dataset):
        def __getitem__(self, i):
            info = get_worker_info()
            assert info is not None and 0 <= info.id < info.num_workers
            return np.array([info.id, os.environ["WORKER_SEEN"] == "yes"],
                            np.int64)

        def __len__(self):
            return 8

    def init(wid):
        os.environ["WORKER_SEEN"] = "yes"

    rows = np.concatenate([b.numpy() for b in _mk_loader(
        DS(), num_workers=2, worker_init_fn=init)])
    assert set(rows[:, 0].tolist()).issubset({0, 1})
    assert rows[:, 1].all()
    assert get_worker_info() is None


def test_worker_death_raises_instead_of_hanging():
    class Killer(Dataset):
        def __getitem__(self, i):
            if i == 5:
                os._exit(13)
            return np.float32(i)

        def __len__(self):
            return 12

    with pytest.raises(RuntimeError, match="worker"):
        for _ in _mk_loader(Killer(), num_workers=2):
            pass


def test_worker_exception_propagates():
    class Bad(Dataset):
        def __getitem__(self, i):
            if i == 3:
                raise ValueError("boom-at-3")
            return np.float32(i)

        def __len__(self):
            return 8

    for workers in (2, 0):
        with pytest.raises((RuntimeError, ValueError), match="boom-at-3"):
            for _ in _mk_loader(Bad(), num_workers=workers):
                pass


def test_iterable_dataset_workers_shard_via_worker_info():
    class Stream(IterableDataset):
        def __iter__(self):
            info = get_worker_info()
            wid = info.id if info else 0
            n = info.num_workers if info else 1
            for i in range(wid, 16, n):
                yield np.float32(i)

    for workers in (2, 0):
        got = []
        for batch in DataLoader(Stream(), batch_size=2, num_workers=workers):
            got.extend(batch.numpy().tolist())
        assert sorted(got) == [float(i) for i in range(16)], sorted(got)


def test_workers_overlap_slow_decode():
    """Four workers fetch in parallel: the time from the first batch to
    the last (so the forks' start-up, long where the parent is a large
    process on a loaded host, is not counted) is well under the serial
    loader's."""
    class Slow(Dataset):
        def __getitem__(self, i):
            time.sleep(0.05)
            return np.full((4,), i, np.float32)

        def __len__(self):
            return 32

    def first_to_last(workers):
        stamps = [time.perf_counter() for _ in _mk_loader(
            Slow(), num_workers=workers)]
        assert len(stamps) == 8
        return stamps[-1] - stamps[0]

    serial = first_to_last(0)
    parallel = first_to_last(4)
    if parallel >= serial * 0.75:  # a loaded box can starve the workers
        parallel = first_to_last(4)
    assert parallel < serial * 0.75, (serial, parallel)


# -- samplers, random_split and collate, like the reference's ---------------------
class _Range(Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i)

    def __len__(self):
        return self.n


def _orders(io, n=10):
    ds = _Range(n)
    np.random.seed(5)
    out = [list(io.RandomSampler(ds)),
           list(io.RandomSampler(ds, replacement=True, num_samples=6)),
           list(io.SubsetRandomSampler([1, 3, 5, 7])),
           list(io.WeightedRandomSampler([1, 2, 3, 4], 5)),
           [list(b) for b in io.BatchSampler(ds, shuffle=True, batch_size=3)],
           [list(b) for b in io.BatchSampler(ds, batch_size=4,
                                             drop_last=True)],
           [[list(b) for b in io.DistributedBatchSampler(
               ds, 2, num_replicas=3, rank=r, shuffle=True)]
            for r in range(3)],
           [list(s.indices) for s in io.random_split(ds, [0.3, 0.7])]]
    return out


def test_samplers_and_random_split_like_jax():
    assert _orders(tp.io) == _orders(jp.io)
    ds = _Range(10)
    assert list(SequenceSampler(ds)) == list(range(10))
    assert len(BatchSampler(ds, batch_size=4)) == 3
    assert len(BatchSampler(ds, batch_size=4, drop_last=True)) == 2
    assert len(RandomSampler(ds, num_samples=4)) == 4
    assert len(WeightedRandomSampler([1, 1], 7)) == 7
    parts = random_split(ds, [3, 7])
    assert sorted(parts[0].indices + parts[1].indices) == list(range(10))
    sampler = DistributedBatchSampler(ds, 2, num_replicas=2, rank=1)
    assert [list(b) for b in sampler] == [[1, 3], [5, 7], [9]]
    assert len(sampler) == 3
    sub = Subset(ds, [4, 2])
    assert len(sub) == 2 and sub[1] == 2
    t = TensorDataset([tp.to_tensor(np.arange(6).reshape(3, 2))])
    assert len(t) == 3 and t[1][0].numpy().tolist() == [2, 3]


def test_default_collate_like_jax():
    batch = [(np.full((2,), i, np.float64), i, float(i) / 2,
              {"a": np.int32(i)}, tp.to_tensor([i, i]))
             for i in range(3)]
    got = default_collate_fn(batch)
    want = jp.io.default_collate_fn([tuple(
        jp.to_tensor(f.numpy()) if isinstance(f, tp.Tensor) else f
        for f in s) for s in batch])
    for g, w in zip(got[:3] + [got[3]["a"], got[4]],
                    want[:3] + [want[3]["a"], want[4]]):
        assert g.dtype.name == str(np.asarray(w.numpy()).dtype), g.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
    assert got[0].dtype == tp.float32      # float64 arrives as float32


# -- the place -------------------------------------------------------------------
def test_prefetching_loader_builds_batches_on_the_iterating_threads_place():
    """The producer thread's own place would resolve the card (and raise
    where there is none): every batch lands on the place captured at
    ``iter()``, and a transform's ``to_tensor`` runs there too."""
    class DS(Dataset):
        def __getitem__(self, i):
            return tp.to_tensor(np.full((2,), i, np.float32)), np.int64(i)

        def __len__(self):
            return 6

    seen = []
    for workers in (0, 2):
        loader = DataLoader(DS(), batch_size=2, num_workers=workers,
                            prefetch_factor=2)
        for x, y in loader:
            seen.append((x.place, y.place))
            assert x.numpy()[:, 0].tolist() == y.numpy().tolist()
    assert seen and all(str(p) == "Place(cpu:0)" for pair in seen
                        for p in pair)
    producers = []

    def probe():
        # a fresh thread has no place of its own: resolving one here
        # needs the card
        producers.append(getattr(tdevice._state, "device", None))

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    assert producers == [None]


def test_worker_sets_the_cpu_place_and_one_thread():
    """A forked worker's place is the CPU before ``worker_init_fn``, and
    its torch runs one thread."""
    class DS(Dataset):
        def __getitem__(self, i):
            t = tp.to_tensor([1.0])
            return np.array([tp.get_device() == "cpu:0",
                             str(t.place) == "Place(cpu:0)",
                             torch.get_num_threads() == 1], np.int64)

        def __len__(self):
            return 4

    def init(wid):
        if tp.get_device() != "cpu:0":
            raise RuntimeError(f"worker {wid} place {tp.get_device()}")

    rows = np.concatenate([b.numpy() for b in _mk_loader(
        DS(), num_workers=2, worker_init_fn=init)])
    assert rows.all(), rows
    # the setup itself, in a thread whose place is the card's
    from paddle_tpu_torch.io import _worker_setup

    got, threads = [], torch.get_num_threads()

    def run():
        tdevice._state.device = torch.device("cuda", 0)
        tdevice._state.place = tp.CUDAPlace(0)
        _worker_setup()
        got.append((tdevice._state.device, tp.get_device()))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    torch.set_num_threads(threads)
    assert got == [(torch.device("cpu"), "cpu:0")]


def test_iterable_worker_sets_the_cpu_place_and_one_thread():
    """The iterable pool's workers get the same setup before
    ``worker_init_fn``: the CPU place and one torch thread, against a
    parent that runs two."""
    class Stream(IterableDataset):
        def __iter__(self):
            for _ in range(2):
                t = tp.to_tensor([1.0])
                yield np.array([tp.get_device() == "cpu:0",
                                str(t.place) == "Place(cpu:0)",
                                torch.get_num_threads() == 1], np.int64)

    def init(wid):
        if tp.get_device() != "cpu:0" or torch.get_num_threads() != 1:
            raise RuntimeError(f"worker {wid} place {tp.get_device()} "
                               f"threads {torch.get_num_threads()}")

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rows = np.concatenate([b.numpy() for b in DataLoader(
            Stream(), batch_size=2, num_workers=2, worker_init_fn=init)])
    finally:
        torch.set_num_threads(threads)
    assert rows.shape == (4, 3) and rows.all(), rows


# -- save / load -----------------------------------------------------------------
def _state():
    tp.seed(0)
    return {
        "w": tp.create_parameter([3, 2], "float32"),
        "b16": tp.to_tensor(np.array([1.5, -2.25, 3e-3],
                                     np.float32)).astype("bfloat16"),
        "i64": tp.to_tensor(np.array([1, 2 ** 40, -3], np.int64)),
        "nested": {"list": [tp.randn([2]), (tp.ones([1], "int32"), 7)],
                   "name": "x", "f": 1.5},
        "raw": torch.arange(4, dtype=torch.float32),
    }


def _bits(t):
    data = t._data if isinstance(t, tp.Tensor) else t
    return data.reshape(-1).view(torch.uint8).tolist(), str(data.dtype)


def _same(a, b):
    if isinstance(a, (tp.Tensor, torch.Tensor)):
        assert type(a) is type(b)
        assert _bits(a) == _bits(b)
        assert list(a.shape) == list(b.shape)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_save_load_round_trip(tmp_path):
    state = _state()
    path = str(tmp_path / "sub" / "state.pdparams")
    tp.save(state, path)
    back = tp.load(path)
    _same(state, back)
    assert isinstance(back["w"], tp.Parameter) and back["w"].trainable
    assert back["b16"].dtype == tp.bfloat16
    arrays = tp.load(path, return_numpy=True)
    np.testing.assert_array_equal(
        arrays["b16"], torch.tensor([1.5, -2.25, 3e-3]).bfloat16().float())
    assert arrays["i64"].dtype == np.int64 and arrays["i64"][1] == 2 ** 40


def test_async_save(tmp_path):
    state = _state()
    path = str(tmp_path / "a.pdparams")
    tp.async_save(state, path)
    tp.async_save({"later": tp.ones([2])}, path, sync_other_task=True)
    tp.clear_async_save_task_queue()
    assert list(tp.load(path)) == ["later"]
    tp.async_save(state, path)
    tp.clear_async_save_task_queue()
    _same(state, tp.load(path))
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
