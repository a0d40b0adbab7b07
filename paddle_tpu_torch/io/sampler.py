"""Samplers (port of ``paddle_tpu/io/sampler.py``).

The random samplers draw from the port's generator for the CPU
(``core.random``), or from the ``torch.Generator`` they are given; the
reference draws from numpy's global one. ``DistributedBatchSampler``
shuffles with ``numpy.random.RandomState(epoch)``, as the reference does,
so its shards are the reference's; its ``num_replicas`` and ``rank``
default to the initialized ``torch.distributed`` group's, else 1 and 0.
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from ..core.random import default_generator

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "SubsetRandomSampler"]


def _gen(generator):
    return generator or default_generator.generator("cpu")


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return (self._num_samples if self._num_samples is not None
                else len(self.data_source))

    def __iter__(self):
        n, g = len(self.data_source), _gen(self.generator)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=g).tolist())
        return iter(torch.randperm(n, generator=g).tolist()[
            : self.num_samples])

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        perm = torch.randperm(len(self.indices), generator=_gen(None))
        return iter([self.indices[i] for i in perm.tolist()])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        idx = torch.multinomial(torch.from_numpy(self.weights),
                                self.num_samples, self.replacement,
                                generator=_gen(None))
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

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


def _world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches: the (optionally shuffled) indices padded to a
    multiple of ``num_replicas``, each rank taking a contiguous share."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        world, me = _world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
            self.epoch += 1
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank * self.num_samples:
                          (self.local_rank + 1) * self.num_samples]
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
