"""paddle_tpu_torch's ``paddle.io`` against paddle_tpu's, on the CPU.

- The samplers' index streams equal the JAX package's where they are
  deterministic: ``SequenceSampler``, ``BatchSampler`` with and without
  ``drop_last``, and every rank's share of ``DistributedBatchSampler``,
  shuffled too (both shuffle with ``numpy.random.RandomState(epoch)``).
  The random samplers give seeded permutations (or draws) of the right
  length and range, the same ones again under the same seed.
- The datasets' items and lengths equal the reference's.
- ``DataLoader`` batches equal the JAX ``DataLoader``'s for the same
  ``TensorDataset``, a custom ``collate_fn``, an ``IterableDataset`` and
  ``batch_size=None``, with ``num_workers=0``; two worker processes and
  two worker threads give the same batches in the same order, each run
  under a deadline of its own (the loader's ``timeout``); a failing sample
  surfaces as an error and the workers are gone afterwards.
- ``hapi.Model.fit`` over a ``Dataset`` gives the same losses, bitwise, as
  ``fit`` over the same batches passed as an iterable (2-layer tiny
  Llama).
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

DEADLINE_S = 60


def _arrays(n=10):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int64))


def test_module_names_are_the_references():
    for m in ("dataset", "sampler", "dataloader"):
        assert sorted(getattr(tio, m).__all__) == \
            sorted(getattr(jio, m).__all__), m


@pytest.mark.parametrize("n,batch,drop_last", [(10, 3, False), (10, 3, True),
                                                (9, 3, True), (2, 5, False)])
def test_sequence_and_batch_samplers_match(n, batch, drop_last):
    data = list(range(n))
    assert list(tio.SequenceSampler(data)) == list(jio.SequenceSampler(data))
    t = tio.BatchSampler(data, batch_size=batch, drop_last=drop_last)
    j = jio.BatchSampler(data, batch_size=batch, drop_last=drop_last)
    assert list(t) == list(j) and len(t) == len(j)
    t = tio.BatchSampler(sampler=tio.SequenceSampler(data), batch_size=batch)
    assert list(t) == list(jio.BatchSampler(
        sampler=jio.SequenceSampler(data), batch_size=batch))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,replicas,batch,drop_last", [
    (10, 3, 2, False), (10, 3, 2, True), (16, 4, 3, False), (5, 1, 2, False)])
def test_distributed_batch_sampler_shards_match(n, replicas, batch,
                                                drop_last, shuffle):
    data = list(range(n))
    for rank in range(replicas):
        t = tio.DistributedBatchSampler(data, batch, num_replicas=replicas,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        j = jio.DistributedBatchSampler(data, batch, num_replicas=replicas,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        for epoch in range(2):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


def test_distributed_batch_sampler_defaults_to_one_process():
    s = tio.DistributedBatchSampler(list(range(7)), 2)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1], [2, 3], [4, 5], [6]]


def test_random_samplers_are_seeded_draws():
    data = list(range(20))
    for make in (lambda: tio.RandomSampler(data),
                 lambda: tio.SubsetRandomSampler(data),
                 lambda: tio.BatchSampler(data, shuffle=True, batch_size=20)):
        pt.seed(4)
        a = list(make())
        pt.seed(4)
        b = list(make())
        flat = a[0] if isinstance(a[0], list) else a
        assert a == b and sorted(flat) == data and flat != data
    pt.seed(1)
    r = list(tio.RandomSampler(data, replacement=True, num_samples=50))
    assert len(r) == 50 and set(r) <= set(data)
    assert len(list(tio.RandomSampler(data, num_samples=5))) == 5
    w = list(tio.WeightedRandomSampler([0.0, 1.0, 0.0, 3.0], 400))
    assert set(w) == {1, 3} and abs(w.count(3) / 400 - 0.75) < 0.08
    w = list(tio.WeightedRandomSampler([1, 1, 1, 1], 4, replacement=False))
    assert sorted(w) == [0, 1, 2, 3]
    g = torch.Generator().manual_seed(2)
    a = list(tio.RandomSampler(data, generator=g))
    g.manual_seed(2)
    assert list(tio.RandomSampler(data, generator=g)) == a


def test_datasets_match():
    x, y = _arrays()
    tds = tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    jds = jio.TensorDataset([x, y])
    assert len(tds) == len(jds) == 10
    for i in (0, 3, -1):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tcat = tio.ConcatDataset([tio.Subset(tds, [1, 2]), tds])
    jcat = jio.ConcatDataset([jio.Subset(jds, [1, 2]), jds])
    assert len(tcat) == len(jcat) == 12
    for i in (0, 1, 2, 11, -1):
        np.testing.assert_array_equal(tcat[i][0].numpy(), jcat[i][0])
    tcomp = tio.ComposeDataset([tds, tds])
    assert len(tcomp[4]) == len(jio.ComposeDataset([jds, jds])[4]) == 4

    class Count(tio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert [v for v in tio.ChainDataset([Count(2), Count(3)])] == \
        [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        len(Count(2))
    pt.seed(7)
    parts = tio.random_split(tds, [0.5, 0.3, 0.2])
    assert [len(p) for p in parts] == [5, 3, 2]
    idx = sorted(i for p in parts for i in p.indices)
    assert idx == list(range(10))
    pt.seed(7)
    assert [p.indices for p in tio.random_split(tds, [0.5, 0.3, 0.2])] == \
        [p.indices for p in parts]
    with pytest.raises(ValueError):
        tio.random_split(tds, [3, 3])


def _same_batches(tb, jb):
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(u), C._np(v))


@pytest.mark.parametrize("batch,drop_last",
                         [(3, False), (3, True), (4, False)])
def test_dataloader_batches_match(batch, drop_last):
    x, y = _arrays()
    tl = tio.DataLoader(tio.TensorDataset([x, y]), batch_size=batch,
                        drop_last=drop_last)
    jl = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=batch,
                        drop_last=drop_last)
    tb, jb = list(tl), list(jl)
    assert len(tl) == len(jl)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in tb for t in b)
    _same_batches(tb, jb)


def test_dataloader_collate_iterable_and_unbatched_match():
    x, y = _arrays()

    def collate(samples):           # the reference's shape of a custom one
        return {"x": np.stack([s[0] for s in samples]) * 2,
                "n": len(samples)}

    tb = list(tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                             collate_fn=collate))
    jb = list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                             collate_fn=collate))
    assert [b["n"] for b in tb] == [b["n"] for b in jb] == [4, 4, 2]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a["x"], b["x"])

    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter([{"v": np.float32(i), "s": "a"} for i in range(5)])

    class JStream(jio.IterableDataset):
        def __iter__(self):
            return iter([{"v": np.float32(i), "s": "a"} for i in range(5)])

    for drop_last in (False, True):
        tb = list(tio.DataLoader(Stream(), batch_size=2, drop_last=drop_last))
        jb = list(jio.DataLoader(JStream(), batch_size=2,
                                 drop_last=drop_last))
        assert len(tb) == len(jb) == (2 if drop_last else 3)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a["v"].numpy(), C._np(b["v"]))
            assert a["s"] == b["s"]
    tb = list(tio.DataLoader(tio.TensorDataset([x]), batch_size=None))
    jb = list(jio.DataLoader(jio.TensorDataset([x]), batch_size=None))
    _same_batches(tb, jb)


def _init_worker(wid):
    info = tio.get_worker_info()
    assert info.id == wid and info.num_workers == 2


@pytest.mark.parametrize("shared_memory", [True, False],
                         ids=["processes", "threads"])
def test_dataloader_workers_keep_the_order(shared_memory):
    """Two workers give the batches of num_workers=0, in order, within the
    loader's own deadline (``timeout``); the worker processes are gone when
    iteration ends."""
    x, y = _arrays(40)
    ds = tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    want = list(tio.DataLoader(ds, batch_size=3))
    loader = tio.DataLoader(ds, batch_size=3, num_workers=2,
                            use_shared_memory=shared_memory,
                            timeout=DEADLINE_S,
                            worker_init_fn=None if shared_memory
                            else _init_worker)
    t0 = time.monotonic()
    got = list(loader)
    assert time.monotonic() - t0 < DEADLINE_S
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    import multiprocessing as mp

    assert not [p for p in mp.active_children()
                if p.name.startswith("Process")]


class _Broken(tio.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample 5")
        return np.float32(i)

    def __len__(self):
        return 8


def test_dataloader_worker_error_surfaces():
    loader = tio.DataLoader(_Broken(), batch_size=2, num_workers=2,
                            use_shared_memory=False, timeout=DEADLINE_S)
    with pytest.raises(KeyError, match="sample 5"):
        list(loader)


def test_dataloader_dead_worker_surfaces_before_the_timeout():
    """A worker process that exits (``collate_fn=sys.exit`` raises
    SystemExit there) is found dead at the next 5 s liveness check, not
    after the loader's whole ``timeout``."""
    import sys

    x, _ = _arrays(8)
    loader = tio.DataLoader(tio.TensorDataset([torch.from_numpy(x)]),
                            batch_size=2, num_workers=1,
                            collate_fn=sys.exit, timeout=DEADLINE_S)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        list(loader)
    assert time.monotonic() - t0 < DEADLINE_S / 2


def test_dataloader_start_method_follows_what_a_child_can_load(
        monkeypatch):
    import sys
    import types

    ds = tio.TensorDataset([torch.zeros(4, 2)])
    for main, want in ((types.SimpleNamespace(__spec__=None,
                                              __file__="<stdin>"), "fork"),
                       (types.SimpleNamespace(__spec__=None), "forkserver"),
                       (types.SimpleNamespace(__spec__=None,
                                              __file__=__file__),
                        "forkserver")):
        monkeypatch.setitem(sys.modules, "__main__", main)
        assert tio.DataLoader(ds, num_workers=2)._start_method() == want


def test_model_fit_over_a_dataset_matches_fit_over_batches():
    from paddle_tpu_torch import LlamaForCausalLM, Model, llama_config
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.nn.layer import loss as tloss

    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, (24, 16)).astype(np.int64)
    labels = rng.randint(0, 256, (24, 16)).astype(np.int64)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.seen = []

        def on_train_batch_end(self, step, logs=None):
            self.seen.append(logs["loss"])

    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for data in ("dataset", "batches"):
        model.load_state_dict(init)
        m = Model(model)
        m.prepare(topt.AdamW(learning_rate=1e-3,
                             parameters=model.parameters()),
                  tloss.CrossEntropyLoss())
        rec = Losses()
        if data == "dataset":
            train = tio.TensorDataset([ids, labels])
        else:
            train = [(ids[i:i + 8], labels[i:i + 8]) for i in (0, 8, 16)]
        m.fit(train, batch_size=8, shuffle=False, epochs=2, verbose=0,
              callbacks=[rec])
        runs.append(rec.seen)
    assert len(runs[0]) == 6 and len(set(runs[0])) == 6
    assert runs[0] == runs[1]
