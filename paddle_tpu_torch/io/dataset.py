"""Datasets (port of ``paddle_tpu/io/dataset.py``). ``random_split``
permutes with the port's generator (``core.random``) unless it is given a
``torch.Generator``."""
from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch

from ..core.random import default_generator

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


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
        raise RuntimeError("IterableDataset does not support len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        if len({t.shape[0] for t in tensors}) != 1:
            raise ValueError("all tensors must share dim-0 size")
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("all datasets must have the same length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(l, float) and 0 <= l <= 1 for l in lengths):
        sizes = [int(np.floor(total * l)) for l in lengths]
        for i in range(total - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != total:
        raise ValueError("sum of input lengths != dataset length")
    gen = generator or default_generator.generator("cpu")
    perm = torch.randperm(total, generator=gen).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out
