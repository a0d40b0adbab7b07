"""``paddle.vision.datasets`` (port of ``paddle_tpu/vision/datasets.py``):
MNIST and FashionMNIST (idx files, gzipped or not), Cifar10 and Cifar100
(the python-pickle tar), ``DatasetFolder`` (a folder per class; ``.npy``
images through ``np.load`` by default), ``ImageFolder``, Flowers (jpg
folder and ``scipy.io.loadmat`` label and split files) and VOC2012 (an
extracted ``VOCdevkit/VOC2012``). Each reads local paths only and never
fetches: MNIST and Cifar without a file give the reference's seeded
synthetic data (``download=True`` raises), Flowers and VOC2012 raise.
Samples are numpy arrays, as the reference's, for the transforms and the
loader's collate."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder"]


class MNIST(Dataset):
    """reference datasets/mnist.py — idx-format loader + synthetic mode."""

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 backend: str = "cv2"):
        self.transform = transform
        self.mode = mode
        if image_path and os.path.exists(image_path):
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            if download:
                raise RuntimeError(
                    "no network egress in this environment; place idx files "
                    "locally and pass image_path/label_path")
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = 1024 if mode == "train" else 256
            self.images = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
            self.labels = rng.randint(0, 10, (n, 1)).astype(np.int64)

    @staticmethod
    def _read_images(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)

    @staticmethod
    def _read_labels(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype(
                np.int64).reshape(n, 1)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """reference datasets/cifar.py — python-pickle batches + synthetic mode."""

    N_CLASSES = 10

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 backend: str = "cv2"):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.data, self.labels = self._load(data_file, mode)
        else:
            if download:
                raise RuntimeError("no network egress; pass data_file")
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = 1024 if mode == "train" else 256
            self.data = rng.randint(0, 256, (n, 3, 32, 32), dtype=np.uint8)
            self.labels = rng.randint(0, self.N_CLASSES, (n,)).astype(np.int64)

    def _load(self, path, mode):
        imgs, labels = [], []
        with tarfile.open(path) as tf:
            names = [m for m in tf.getmembers()
                     if ("data_batch" in m.name if mode == "train"
                         else "test_batch" in m.name)]
            for m in names:
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                imgs.append(np.asarray(d[b"data"]).reshape(-1, 3, 32, 32))
                key = b"labels" if b"labels" in d else b"fine_labels"
                labels.append(np.asarray(d[key], np.int64))
        return np.concatenate(imgs), np.concatenate(labels)

    def __getitem__(self, idx):
        img = self.data[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    N_CLASSES = 100


class DatasetFolder(Dataset):
    """reference datasets/folder.py — class-per-subdir image tree (numpy .npy
    files in this no-PIL environment)."""

    def __init__(self, root: str, loader=None, extensions=(".npy",),
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or np.load
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat-folder image dataset (reference datasets/folder.py
    ImageFolder): every image under root, no labels."""

    _EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        exts = tuple(e.lower() for e in (extensions or self._EXTS))
        self.root = root
        self.transform = transform
        self.loader = loader
        samples = []
        for dirpath, _, names in sorted(os.walk(root)):
            for fn in sorted(names):
                path = os.path.join(dirpath, fn)
                ok = (is_valid_file(path) if is_valid_file
                      else fn.lower().endswith(exts))
                if ok:
                    samples.append(path)
        if not samples:
            raise RuntimeError(f"Found 0 files in {root}")
        self.samples = samples

    def _load(self, path):
        if self.loader is not None:
            return self.loader(path)
        from .image import image_load

        img = image_load(path)
        return np.asarray(img)

    def __getitem__(self, idx):
        img = self._load(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Oxford-102 flowers (reference datasets/flowers.py). Zero-egress:
    pass data_file (102flowers.tgz extracted dir with jpg/) + label_file
    (imagelabels.mat) + setid_file (setid.mat)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        if not (data_file and os.path.exists(data_file)):
            raise RuntimeError(
                "Flowers: no local data. Fetch 102flowers.tgz / "
                "imagelabels.mat / setid.mat on a connected machine and "
                "pass their paths (this build has no network egress).")
        import scipy.io

        labels = scipy.io.loadmat(label_file)["labels"].ravel()
        setid = scipy.io.loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        self.indexes = setid[key].ravel()
        self.labels = labels
        self.data_dir = data_file
        self.transform = transform

    def __getitem__(self, idx):
        img_idx = int(self.indexes[idx])
        path = os.path.join(self.data_dir, f"image_{img_idx:05d}.jpg")
        from .image import image_load

        img = np.asarray(image_load(path))
        if self.transform is not None:
            img = self.transform(img)
        label = np.asarray(self.labels[img_idx - 1] - 1, np.int64)
        return img, label

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (reference datasets/voc2012.py).
    Zero-egress: data_file = extracted VOCdevkit/VOC2012 directory."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if not (data_file and os.path.isdir(data_file)):
            raise RuntimeError(
                "VOC2012: no local data. Extract VOCtrainval_11-May-2012 "
                "on a connected machine and pass VOCdevkit/VOC2012 as "
                "data_file (this build has no network egress).")
        name = {"train": "train", "valid": "val", "test": "val",
                "trainval": "trainval"}[mode]
        list_file = os.path.join(data_file, "ImageSets", "Segmentation",
                                 name + ".txt")
        with open(list_file) as f:
            self.ids = [ln.strip() for ln in f if ln.strip()]
        self.root = data_file
        self.transform = transform

    def __getitem__(self, idx):
        from .image import image_load

        name = self.ids[idx]
        img = np.asarray(image_load(
            os.path.join(self.root, "JPEGImages", name + ".jpg")))
        lbl = np.asarray(image_load(
            os.path.join(self.root, "SegmentationClass", name + ".png")))
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return len(self.ids)


__all__ += ["ImageFolder", "Flowers", "VOC2012"]
