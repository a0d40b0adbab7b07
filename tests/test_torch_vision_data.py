"""paddle_tpu_torch's ``vision.transforms``, ``vision.datasets`` and
``vision.image`` against paddle_tpu's, on the CPU.

- Every name of the reference's ``transforms.__all__`` (38) on a uint8 and
  a float HWC image (and a CHW tensor where the transform takes one):
  bitwise equal outputs. The random transforms run under the same
  ``random.seed`` on both sides, several seeds each, so both branches of a
  flip and the retry loops of the crops are taken.
- Each dataset class on small synthetic files in its format under
  ``tmp_path`` (idx files plain and gzipped, the Cifar pickle tar, class
  folders of ``.npy`` images, jpg folders with ``.mat`` label files, a VOC
  tree): lengths and every sample equal; the missing-file errors.
- ``image_load`` and the backend switch; PIL's cases skip without PIL.
- A ``DatasetFolder`` with a transform pipeline through the port's
  ``DataLoader`` with 2 worker processes (workers closed in ``finally``)
  gives the reference loader's batches.
"""
import gzip
import io as pyio
import os
import pickle
import random
import struct
import sys
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.image as JI
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch.vision.datasets as PD
import paddle_tpu_torch.vision.image as PI
import paddle_tpu_torch.vision.transforms as PT
import torch_nn_cases as C
from paddle_tpu.io import DataLoader as JLoader
from paddle_tpu_torch.io import DataLoader as PLoader

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


@pytest.fixture(autouse=True)
def python_random():
    """The tests seed Python's ``random``; its state is put back."""
    state = random.getstate()
    yield
    random.setstate(state)

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, paddle_tpu.Tensor):
        return C._np(x)
    return np.asarray(x)


def same(got, want, what=""):
    got, want = host(got), host(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def images(seed=0):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (17, 23, 3), np.uint8)
    f32 = rng.rand(17, 23, 3).astype(np.float32)
    return {"uint8": u8, "float": f32}


# name -> (build(module) -> callable, random?); every transform takes an
# HWC image
TRANSFORMS = {
    "Compose": (lambda M: M.Compose([M.RandomResizedCrop(8),
                                     M.RandomHorizontalFlip(),
                                     M.Transpose(),
                                     M.Normalize(MEAN, STD)]), True),
    "ToTensor": (lambda M: M.ToTensor(), False),
    "Normalize": (lambda M: M.Normalize(MEAN, STD, data_format="HWC"),
                  False),
    "Resize": (lambda M: M.Resize((9, 31)), False),
    "CenterCrop": (lambda M: M.CenterCrop(11), False),
    "RandomCrop": (lambda M: M.RandomCrop(20, padding=2,
                                          pad_if_needed=True), True),
    "RandomHorizontalFlip": (lambda M: M.RandomHorizontalFlip(), True),
    "RandomVerticalFlip": (lambda M: M.RandomVerticalFlip(0.3), True),
    "Transpose": (lambda M: M.Transpose(), False),
    "Pad": (lambda M: M.Pad((1, 2, 3, 4), padding_mode="reflect"), False),
    "BrightnessTransform": (lambda M: M.BrightnessTransform(0.4), True),
    "Grayscale": (lambda M: M.Grayscale(3), False),
    "to_tensor": (lambda M: lambda im: M.to_tensor(im, "HWC"), False),
    "normalize": (lambda M: lambda im: M.normalize(im, 0.5, 0.25, "HWC"),
                  False),
    "resize": (lambda M: lambda im: M.resize(im, 12, "nearest"), False),
    "center_crop": (lambda M: lambda im: M.center_crop(im, (5, 30)), False),
    "hflip": (lambda M: M.hflip, False),
    "vflip": (lambda M: M.vflip, False),
    "pad": (lambda M: lambda im: M.pad(im, 3, fill=7), False),
    "crop": (lambda M: lambda im: M.crop(im, 2, 3, 9, 11), False),
    "ColorJitter": (lambda M: M.ColorJitter(0.3, 0.3, 0.3, 0.1), True),
    "ContrastTransform": (lambda M: M.ContrastTransform(0.5), True),
    "SaturationTransform": (lambda M: M.SaturationTransform(0.5), True),
    "HueTransform": (lambda M: M.HueTransform(0.2), True),
    "RandomRotation": (lambda M: M.RandomRotation(30, fill=1), True),
    "RandomAffine": (lambda M: M.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=10), True),
    "RandomPerspective": (lambda M: M.RandomPerspective(0.7), True),
    "RandomResizedCrop": (lambda M: M.RandomResizedCrop((10, 12)), True),
    "RandomErasing": (lambda M: M.RandomErasing(0.8, value=3), True),
    "to_grayscale": (lambda M: M.to_grayscale, False),
    "adjust_brightness": (lambda M: lambda im: M.adjust_brightness(im, 1.3),
                          False),
    "adjust_contrast": (lambda M: lambda im: M.adjust_contrast(im, 0.6),
                        False),
    "adjust_saturation": (lambda M: lambda im: M.adjust_saturation(im, 1.7),
                          False),
    "adjust_hue": (lambda M: lambda im: M.adjust_hue(im, -0.3), False),
    "affine": (lambda M: lambda im: M.affine(im, 15, (2, -1), 1.1,
                                             (5.0, 3.0), fill=2), False),
    "rotate": (lambda M: lambda im: M.rotate(im, 40, center=(4, 6)), False),
    "perspective": (lambda M: lambda im: M.perspective(
        im, [(0, 0), (22, 0), (22, 16), (0, 16)],
        [(2, 1), (20, 3), (21, 15), (1, 14)], fill=5), False),
    "erase": (lambda M: lambda im: M.erase(im, 3, 4, 5, 6, 9), False),
}


def test_every_transform_is_covered():
    assert sorted(PT.__all__) == sorted(JT.__all__)
    assert len(PT.__all__) == 38
    assert set(TRANSFORMS) == set(JT.__all__)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_transform_matches_reference(name, kind):
    build, rand = TRANSFORMS[name]
    img = images(len(name))[kind]
    fj, ft = build(JT), build(PT)
    for s in range(6 if rand else 1):
        random.seed(s)
        want = fj(img.copy())
        random.seed(s)
        got = ft(img.copy())
        if name in ("ToTensor", "to_tensor"):
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        same(got, want, f"{name} {kind} seed {s}")


def test_transforms_take_tensors():
    """A CHW tensor from ``to_tensor`` normalizes into a tensor on both
    sides; a tensor input to a numpy transform reads on the host."""
    img = images(1)["uint8"]
    jx, tx = JT.to_tensor(img), PT.to_tensor(img)
    same(tx, jx)
    got = PT.normalize(tx, [0.4, 0.5, 0.6], [0.2, 0.3, 0.25])
    assert isinstance(got, torch.Tensor)
    same(got, JT.normalize(jx, [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]))
    same(PT.hflip(torch.from_numpy(img)), JT.hflip(img))


def test_random_resized_crop_draw_order():
    """The port draws from Python's ``random`` as the reference does: the
    generator's state after a call is the same on both sides."""
    img = images(2)["uint8"]
    for s in range(5):
        random.seed(s)
        JT.RandomResizedCrop(7, scale=(0.01, 1.0))(img)
        after_j = random.getstate()
        random.seed(s)
        PT.RandomResizedCrop(7, scale=(0.01, 1.0))(img)
        assert random.getstate() == after_j


# -- datasets -------------------------------------------------------------


def _idx(path, arr, gz):
    head = (struct.pack(">IIII", 2051, *arr.shape) if arr.ndim == 3
            else struct.pack(">II", 2049, arr.shape[0]))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def same_samples(pd, jd, what):
    assert len(pd) == len(jd), what
    for i in range(len(jd)):
        want, got = jd[i], pd[i]
        if not isinstance(want, (list, tuple)):
            want, got = [want], [got]
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            same(g, w, f"{what}[{i}]")


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("gz", [False, True])
def test_mnist_files(tmp_path, cls, gz):
    rng = np.random.RandomState(gz)
    imgs = rng.randint(0, 256, (7, 28, 28))
    labels = rng.randint(0, 10, (7,))
    ext = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"img{ext}"), str(tmp_path / f"lab{ext}")
    _idx(ip, imgs, gz)
    _idx(lp, labels, gz)
    jd = getattr(JD, cls)(ip, lp)
    pd = getattr(PD, cls)(ip, lp)
    assert len(pd) == 7
    same_samples(pd, jd, cls)
    same_samples(getattr(PD, cls)(ip, lp, transform=PT.to_tensor),
                 getattr(JD, cls)(ip, lp, transform=JT.to_tensor),
                 cls + " transformed")


def test_mnist_synthetic_and_download():
    same_samples(PD.MNIST(mode="test"), JD.MNIST(mode="test"), "synthetic")
    with pytest.raises(RuntimeError, match="egress"):
        PD.MNIST(download=True)
    with pytest.raises(RuntimeError, match="egress"):
        PD.Cifar10(download=True)


def _cifar(path, fine):
    rng = np.random.RandomState(int(fine))
    key = b"fine_labels" if fine else b"labels"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("cifar/data_batch_1", 5), ("cifar/data_batch_2", 3),
                        ("cifar/test_batch", 4)):
            d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 key: rng.randint(0, 100 if fine else 10, n).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tf.addfile(info, pyio.BytesIO(raw))


@pytest.mark.parametrize("cls", ["Cifar10", "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_files(tmp_path, cls, mode):
    path = str(tmp_path / "cifar.tar.gz")
    _cifar(path, cls == "Cifar100")
    jd = getattr(JD, cls)(path, mode=mode)
    pd = getattr(PD, cls)(path, mode=mode)
    assert len(pd) == (8 if mode == "train" else 4)
    same_samples(pd, jd, cls)
    same_samples(getattr(PD, cls)(mode=mode), getattr(JD, cls)(mode=mode),
                 cls + " synthetic")


def _class_tree(root, rng, n_classes=3, per_class=4, size=(12, 14)):
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        for i in range(per_class):
            h = size[0] + rng.randint(0, 5)
            w = size[1] + rng.randint(0, 5)
            np.save(os.path.join(d, f"{i:03d}.npy"),
                    rng.randint(0, 256, (h, w, 3), np.uint8))
        open(os.path.join(d, "notes.txt"), "w").close()


def test_dataset_folder(tmp_path):
    _class_tree(str(tmp_path), np.random.RandomState(0))
    jd = JD.DatasetFolder(str(tmp_path))
    pd = PD.DatasetFolder(str(tmp_path))
    assert pd.classes == jd.classes and pd.samples == jd.samples
    assert pd.class_to_idx == jd.class_to_idx and len(pd) == 12
    same_samples(pd, jd, "DatasetFolder")


def test_image_folder(tmp_path):
    _class_tree(str(tmp_path), np.random.RandomState(1))
    jd = JD.ImageFolder(str(tmp_path), loader=np.load, extensions=(".npy",))
    pd = PD.ImageFolder(str(tmp_path), loader=np.load, extensions=(".npy",))
    assert pd.samples == jd.samples and len(pd) == 12
    same_samples(pd, jd, "ImageFolder")
    with pytest.raises(RuntimeError, match="Found 0 files"):
        PD.ImageFolder(str(tmp_path), extensions=(".png",))


def _jpg(path, rng, shape=(10, 12, 3)):
    from PIL import Image

    Image.fromarray(rng.randint(0, 256, shape, np.uint8)).save(path)


def test_image_folder_pil_and_flowers(tmp_path):
    pytest.importorskip("PIL")
    import scipy.io

    rng = np.random.RandomState(2)
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    for i in range(1, 7):
        _jpg(str(jpg / f"image_{i:05d}.jpg"), rng)
    same_samples(PD.ImageFolder(str(jpg)), JD.ImageFolder(str(jpg)),
                 "ImageFolder pil")
    labels, setid = str(tmp_path / "labels.mat"), str(tmp_path / "setid.mat")
    scipy.io.savemat(labels, {"labels": np.asarray([[3, 1, 2, 2, 1, 3]])})
    scipy.io.savemat(setid, {"trnid": np.asarray([[1, 4, 5]]),
                             "valid": np.asarray([[2]]),
                             "tstid": np.asarray([[3, 6]])})
    for mode in ("train", "valid", "test"):
        jd = JD.Flowers(str(jpg), labels, setid, mode=mode)
        pd = PD.Flowers(str(jpg), labels, setid, mode=mode)
        same_samples(pd, jd, f"Flowers {mode}")
    with pytest.raises(RuntimeError, match="no local data"):
        PD.Flowers(str(tmp_path / "missing"), labels, setid)


def test_voc2012(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(3)
    root = tmp_path / "VOC2012"
    for d in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
        (root / d).mkdir(parents=True)
    ids = ["2007_000001", "2007_000002", "2007_000003"]
    (root / "ImageSets/Segmentation/train.txt").write_text(
        "\n".join(ids[:2]) + "\n")
    (root / "ImageSets/Segmentation/val.txt").write_text(ids[2] + "\n")
    for name in ids:
        _jpg(str(root / "JPEGImages" / f"{name}.jpg"), rng)
        Image.fromarray(rng.randint(0, 21, (10, 12), np.uint8)).save(
            str(root / "SegmentationClass" / f"{name}.png"))
    for mode in ("train", "valid"):
        same_samples(PD.VOC2012(str(root), mode=mode),
                     JD.VOC2012(str(root), mode=mode), f"VOC {mode}")
    with pytest.raises(RuntimeError, match="no local data"):
        PD.VOC2012(str(tmp_path / "missing"))


def test_image_backend(tmp_path, monkeypatch):
    assert PI.get_image_backend() == JI.get_image_backend() == "pil"
    with pytest.raises(ValueError, match="pil"):
        PI.set_image_backend("tf")
    monkeypatch.setitem(sys.modules, "cv2", None)      # cv2 not installed
    with pytest.raises(ModuleNotFoundError):
        PI.set_image_backend("cv2")
    with pytest.raises(ModuleNotFoundError):
        JI.set_image_backend("cv2")
    assert PI.get_image_backend() == "pil"
    pytest.importorskip("PIL")
    path = str(tmp_path / "a.png")
    _jpg(path, np.random.RandomState(4))
    same(np.asarray(PI.image_load(path)), np.asarray(JI.image_load(path)))


# -- the loader ---------------------------------------------------------------


def test_dataset_folder_loader_batches(tmp_path):
    """A DatasetFolder through a transform pipeline and a 2-worker
    DataLoader: the batches of the reference's loader, in order."""
    _class_tree(str(tmp_path), np.random.RandomState(5), per_class=5)

    def pipe(M):
        return M.Compose([M.Resize(10), M.CenterCrop(9), M.Transpose(),
                          M.Normalize(MEAN, STD)])

    jd = JD.DatasetFolder(str(tmp_path), transform=pipe(JT))
    pd = PD.DatasetFolder(str(tmp_path), transform=pipe(PT))
    want = [[host(t) for t in b]
            for b in JLoader(jd, batch_size=4, shuffle=False)]
    loader = PLoader(pd, batch_size=4, shuffle=False, num_workers=2,
                     timeout=120)
    it = iter(loader)
    try:
        got = [[host(t) for t in b] for b in it]
    finally:
        it.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        same(g[0], w[0], "images")
        np.testing.assert_array_equal(g[1], w[1])
        assert g[0].shape[1:] == (3, 9, 9)
