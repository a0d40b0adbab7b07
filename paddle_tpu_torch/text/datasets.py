"""``paddle.text``'s datasets (port of ``paddle_tpu/text/datasets.py``):
UCIHousing, Imdb, Imikolov and Movielens parse a local copy of their
published files (``data_file``); Conll05st, WMT14 and WMT16 are gated, as
in the reference. Nothing is fetched: without a local file each raises
and says what to fetch."""
from __future__ import annotations

import os
import re
import tarfile
from typing import Optional

import numpy as np

from ..io.dataset import Dataset

__all__ = ["UCIHousing", "Imdb", "Imikolov", "Movielens", "Conll05st",
           "WMT14", "WMT16"]


def _require(path: Optional[str], name: str, hint: str) -> str:
    if path and os.path.exists(path):
        return path
    raise RuntimeError(
        f"{name}: no local data. This build has no network egress; fetch "
        f"{hint} on a connected machine and pass its local path.")


class UCIHousing(Dataset):
    """Boston housing regression (reference uci_housing.py). data_file:
    the whitespace-separated housing.data (506 rows x 14 cols)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train"):
        path = _require(data_file, "UCIHousing",
                        "https://archive.ics.uci.edu/ml/machine-learning-"
                        "databases/housing/housing.data")
        raw = np.loadtxt(path).astype(np.float32)
        # reference normalization: per-feature max/min/avg over full set
        maxs = raw.max(axis=0)
        mins = raw.min(axis=0)
        avgs = raw.mean(axis=0)
        feat = (raw[:, :-1] - avgs[:-1]) / (maxs[:-1] - mins[:-1])
        n_train = int(len(raw) * 0.8)
        if mode == "train":
            self.data = feat[:n_train]
            self.label = raw[:n_train, -1:]
        else:
            self.data = feat[n_train:]
            self.label = raw[n_train:, -1:]

    def __getitem__(self, idx):
        return self.data[idx], self.label[idx]

    def __len__(self):
        return len(self.data)


class Imdb(Dataset):
    """IMDB sentiment (reference imdb.py). data_file: aclImdb_v1.tar.gz
    or an extracted aclImdb/ directory."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150):
        path = _require(data_file, "Imdb",
                        "https://ai.stanford.edu/~amaas/data/sentiment/"
                        "aclImdb_v1.tar.gz")
        self._tokenize = re.compile(r"\w+").findall
        docs, labels = [], []
        if os.path.isdir(path):
            texts = self._read_dir(path, mode)
        else:
            texts = self._read_tar(path, mode)
        self.word_idx = self._build_vocab(
            (self._tokenize(t.lower()) for t, _ in texts), cutoff)
        for text, lab in texts:
            toks = self._tokenize(text.lower())
            docs.append(np.array(
                [self.word_idx.get(w, self.word_idx["<unk>"])
                 for w in toks], np.int64))
            labels.append(lab)
        self.docs = docs
        self.labels = np.asarray(labels, np.int64)

    @staticmethod
    def _read_dir(root, mode):
        out = []
        for lab, sub in ((0, "pos"), (1, "neg")):
            d = os.path.join(root, mode, sub)
            for fn in sorted(os.listdir(d)):
                with open(os.path.join(d, fn), encoding="utf-8") as f:
                    out.append((f.read(), lab))
        return out

    @staticmethod
    def _read_tar(path, mode):
        out = []
        pats = {0: re.compile(rf"aclImdb/{mode}/pos/.*\.txt$"),
                1: re.compile(rf"aclImdb/{mode}/neg/.*\.txt$")}
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                for lab, pat in pats.items():
                    if pat.match(member.name):
                        out.append((
                            tf.extractfile(member).read().decode("utf-8"),
                            lab))
        return out

    @staticmethod
    def _build_vocab(token_iter, cutoff):
        freq = {}
        for toks in token_iter:
            for w in toks:
                freq[w] = freq.get(w, 0) + 1
        words = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c > cutoff]
        idx = {w: i for i, w in enumerate(words)}
        idx["<unk>"] = len(idx)
        return idx

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB n-gram dataset (reference imikolov.py). data_file: the
    simple-examples.tgz archive or extracted ptb.{train,valid}.txt."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50):
        path = _require(data_file, "Imikolov",
                        "http://www.fit.vutbr.cz/~imikolov/rnnlm/"
                        "simple-examples.tgz")
        which = "train" if mode == "train" else "valid"
        lines = self._read(path, which)
        train_lines = lines if which == "train" else self._read(path, "train")
        freq = {}
        for ln in train_lines:
            for w in ln.split():
                freq[w] = freq.get(w, 0) + 1
            # sentence boundary markers count once per line (reference
            # imikolov.py build_dict) so BOS/EOS get real vocab ids
            freq["<s>"] = freq.get("<s>", 0) + 1
            freq["<e>"] = freq.get("<e>", 0) + 1
        freq = {w: c for w, c in freq.items() if c >= min_word_freq}
        words = sorted(freq, key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(words)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data = []
        for ln in lines:
            ids = [self.word_idx.get(w, unk) for w in ln.split()]
            ids = [self.word_idx.get("<s>", unk)] + ids \
                + [self.word_idx.get("<e>", unk)]
            if data_type.upper() == "NGRAM":
                for i in range(window_size, len(ids)):
                    self.data.append(np.asarray(ids[i - window_size:i + 1],
                                                np.int64))
            else:  # SEQ
                self.data.append((np.asarray(ids[:-1], np.int64),
                                  np.asarray(ids[1:], np.int64)))

    @staticmethod
    def _read(path, which):
        name = f"ptb.{which}.txt"
        if os.path.isdir(path):
            with open(os.path.join(path, name), encoding="utf-8") as f:
                return f.read().splitlines()
        with tarfile.open(path) as tf:
            member = [m for m in tf.getnames() if m.endswith(name)][0]
            return tf.extractfile(member).read().decode().splitlines()

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens-1M ratings (reference movielens.py). data_file: ml-1m.zip
    or extracted ml-1m/ directory with ratings.dat/users.dat/movies.dat."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0):
        path = _require(data_file, "Movielens",
                        "https://files.grouplens.org/datasets/movielens/"
                        "ml-1m.zip")
        import zipfile

        def read(name):
            if os.path.isdir(path):
                with open(os.path.join(path, name), encoding="latin1") as f:
                    return f.read().splitlines()
            with zipfile.ZipFile(path) as z:
                inner = [n for n in z.namelist() if n.endswith(name)][0]
                return z.read(inner).decode("latin1").splitlines()

        ratings = [ln.split("::") for ln in read("ratings.dat")]
        rng = np.random.RandomState(rand_seed)
        mask = rng.rand(len(ratings)) < test_ratio
        keep = mask if mode == "test" else ~mask
        self.data = [(int(u), int(m), float(r))
                     for (u, m, r, _), k in zip(ratings, keep) if k]

    def __getitem__(self, idx):
        u, m, r = self.data[idx]
        return (np.asarray(u, np.int64), np.asarray(m, np.int64),
                np.asarray(r, np.float32))

    def __len__(self):
        return len(self.data)


class _GatedDataset(Dataset):
    _NAME = ""
    _HINT = ""

    def __init__(self, data_file: Optional[str] = None, **kwargs):
        _require(data_file, self._NAME, self._HINT)
        raise NotImplementedError(
            f"{self._NAME} local parsing is not implemented in this build; "
            "the dataset requires its original preprocessing pipeline.")


class Conll05st(_GatedDataset):
    """CoNLL-2005 SRL (reference conll05.py) — gated (license-restricted
    download)."""
    _NAME = "Conll05st"
    _HINT = "the CoNLL-2005 shared-task distribution"


class WMT14(_GatedDataset):
    """WMT'14 en-fr (reference wmt14.py) — gated."""
    _NAME = "WMT14"
    _HINT = "the pre-tokenized WMT-14 archive"


class WMT16(_GatedDataset):
    """WMT'16 en-de (reference wmt16.py) — gated."""
    _NAME = "WMT16"
    _HINT = "the pre-tokenized WMT-16 archive"
