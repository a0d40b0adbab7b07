"""``paddle.vision.transforms`` (port of ``paddle_tpu/vision/transforms.py``):
the functional forms and the transform classes, in numpy on the host (the
input pipeline runs in the loader's workers; the model moves each batch to
its device). Images are HWC numpy arrays (or tensors, read on the host),
uint8 or float, as the reference's ``cv2`` path takes them; ``to_tensor``
gives a CHW float32 torch tensor on the CPU.

The random transforms draw from Python's ``random`` module in the
reference's order (``RandomResizedCrop``: an area share, then a log aspect
ratio, then the top and left corner, up to ten times), so one
``random.seed`` gives the same crops, flips and jitters as the
reference."""
from __future__ import annotations

import math
import numbers
import random
from typing import Sequence

import numpy as np

import torch

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "Pad", "BrightnessTransform", "Grayscale",
           "to_tensor", "normalize", "resize", "center_crop", "hflip",
           "vflip", "pad", "crop"]


def _np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


# -- functional ---------------------------------------------------------------


def to_tensor(img, data_format: str = "CHW") -> torch.Tensor:
    arr = _np(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


def normalize(img, mean, std, data_format: str = "CHW", to_rgb=False):
    arr = _np(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (arr - mean) / std
    return torch.from_numpy(out) if isinstance(img, torch.Tensor) else out


def resize(img, size, interpolation: str = "bilinear"):
    """Nearest/bilinear resize via numpy (no cv2/PIL dependency)."""
    arr = _np(img)
    if isinstance(size, numbers.Number):
        h, w = arr.shape[:2]
        short = min(h, w)
        scale = size / short
        size = (int(round(h * scale)), int(round(w * scale)))
    oh, ow = size
    h, w = arr.shape[:2]
    if interpolation == "nearest":
        ys = np.clip((np.arange(oh) + 0.5) * h / oh, 0, h - 1).astype(int)
        xs = np.clip((np.arange(ow) + 0.5) * w / ow, 0, w - 1).astype(int)
        return arr[ys][:, xs]
    # bilinear
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = (ys - y0).reshape(-1, 1)
    wx = (xs - x0).reshape(1, -1)
    if arr.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = arr[y0][:, x0]
    b = arr[y0][:, x1]
    c = arr[y1][:, x0]
    d = arr[y1][:, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out.astype(arr.dtype if arr.dtype != np.uint8 else np.float32)


def crop(img, top, left, height, width):
    return _np(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = _np(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = arr.shape[:2]
    th, tw = output_size
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return arr[top:top + th, left:left + tw]


def hflip(img):
    return _np(img)[:, ::-1].copy()


def vflip(img):
    return _np(img)[::-1].copy()


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    arr = _np(img)
    if isinstance(padding, numbers.Number):
        padding = (padding,) * 4  # left, top, right, bottom
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    width = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(arr, width, mode=mode, **kw)


# -- transform classes --------------------------------------------------------


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = _np(img)
        if self.padding is not None:
            arr = pad(arr, self.padding, self.fill, self.padding_mode)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            arr = pad(arr, (max(tw - w, 0), max(th - h, 0)), self.fill,
                      self.padding_mode)
            h, w = arr.shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return arr[top:top + th, left:left + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return hflip(img)
        return _np(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return vflip(img)
        return _np(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        arr = _np(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        arr = _np(img).astype(np.float32) * factor
        return np.clip(arr, 0, 255 if arr.max() > 1 else 1.0)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels: int = 1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        arr = _np(img).astype(np.float32)
        gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2])
        out = gray[..., None]
        if self.num_output_channels == 3:
            out = np.repeat(out, 3, axis=-1)
        return out


# -- color / geometric functional tail (reference transforms/functional.py)


def to_grayscale(img, num_output_channels: int = 1):
    arr = _np(img).astype(np.float32)
    gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2])
    out = gray[..., None]
    if num_output_channels == 3:
        out = np.repeat(out, 3, axis=-1)
    return out


def adjust_brightness(img, brightness_factor):
    arr = _np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1 else 1.0
    return np.clip(arr * brightness_factor, 0, hi)


def adjust_contrast(img, contrast_factor):
    arr = _np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1 else 1.0
    mean = to_grayscale(arr).mean()
    return np.clip(mean + contrast_factor * (arr - mean), 0, hi)


def adjust_saturation(img, saturation_factor):
    arr = _np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1 else 1.0
    gray = to_grayscale(arr, 3)
    return np.clip(gray + saturation_factor * (arr - gray), 0, hi)


def adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor (in [-0.5, 0.5] turns; reference
    functional adjust_hue via HSV roundtrip)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1 else 1.0
    x = arr / hi
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-8
    h = np.zeros_like(mx)
    mask = mx == r
    h[mask] = ((g - b) / diff % 6)[mask]
    mask = mx == g
    h[mask] = ((b - r) / diff + 2)[mask]
    mask = mx == b
    h[mask] = ((r - g) / diff + 4)[mask]
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-8), 0.0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return np.clip(out * hi, 0, hi)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the region [i:i+h, j:j+w] with value v (reference
    functional erase)."""
    arr = _np(img).astype(np.float32).copy()
    arr[..., i:i + h, j:j + w, :] = v
    return arr


def _affine_grid_sample(arr, matrix, fill=0.0):
    """Inverse-warp sampling with bilinear interpolation; matrix maps
    OUTPUT pixel coords -> input coords (3x3 row-major)."""
    hgt, wid = arr.shape[0], arr.shape[1]
    ys, xs = np.meshgrid(np.arange(hgt), np.arange(wid), indexing="ij")
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], axis=-1).astype(np.float32)
    src = coords @ np.asarray(matrix, np.float32).T
    sx, sy = src[..., 0], src[..., 1]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx, fy = sx - x0, sy - y0
    out = np.zeros_like(arr, dtype=np.float32)
    valid = (sx >= -1) & (sx <= wid) & (sy >= -1) & (sy <= hgt)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = np.clip(x0 + dx, 0, wid - 1)
            yi = np.clip(y0 + dy, 0, hgt - 1)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))
            out += arr[yi, xi].astype(np.float32) * wgt[..., None]
    out[~valid] = fill
    return out


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    """Affine warp (reference functional affine): rotate/translate/scale/
    shear about the image center."""
    arr = _np(img).astype(np.float32)
    hgt, wid = arr.shape[0], arr.shape[1]
    cx, cy = center if center is not None else ((wid - 1) / 2,
                                                (hgt - 1) / 2)
    a = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in
              (shear if isinstance(shear, (list, tuple)) else (shear, 0.0)))
    # forward = T(center+translate) @ R(angle) @ Shear @ Scale @ T(-center)
    # (torchvision/reference composition: shear is its own matrix, not an
    # angle offset inside the rotation)
    rot = np.asarray([[np.cos(a), -np.sin(a), 0],
                      [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    shear_m = np.asarray([[1, -np.tan(sx), 0], [-np.tan(sy), 1, 0],
                          [0, 0, 1]], np.float32)
    scale_m = np.asarray([[scale, 0, 0], [0, scale, 0], [0, 0, 1]],
                         np.float32)
    t1 = np.asarray([[1, 0, cx + translate[0]], [0, 1, cy + translate[1]],
                     [0, 0, 1]], np.float32)
    t0 = np.asarray([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    fwd = t1 @ rot @ shear_m @ scale_m @ t0
    inv = np.linalg.inv(fwd)
    return _affine_grid_sample(arr, inv, fill=fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by angle degrees (reference functional
    rotate; expand unsupported keeps the input canvas)."""
    return affine(img, angle=angle, center=center, fill=fill)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Perspective warp mapping startpoints -> endpoints (reference
    functional perspective; homography solved least-squares)."""
    arr = _np(img).astype(np.float32)
    A, b = [], []
    for (x, y), (u, v) in zip(startpoints, endpoints):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.lstsq(np.asarray(A, np.float32),
                        np.asarray(b, np.float32), rcond=None)[0]
    fwd = np.asarray([[h[0], h[1], h[2]], [h[3], h[4], h[5]],
                      [h[6], h[7], 1.0]], np.float32)
    inv = np.linalg.inv(fwd)

    hgt, wid = arr.shape[0], arr.shape[1]
    ys, xs = np.meshgrid(np.arange(hgt), np.arange(wid), indexing="ij")
    coords = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
    src = coords @ inv.T
    src = src[..., :2] / np.maximum(np.abs(src[..., 2:]), 1e-8) * np.sign(
        src[..., 2:])
    sx, sy = src[..., 0], src[..., 1]
    x0 = np.clip(np.round(sx).astype(np.int32), 0, wid - 1)
    y0 = np.clip(np.round(sy).astype(np.int32), 0, hgt - 1)
    out = arr[y0, x0]
    # half-pixel tolerance: exact-boundary coords carry float error
    invalid = ((sx < -0.5) | (sx > wid - 0.5)
               | (sy < -0.5) | (sy > hgt - 0.5))
    out[invalid] = fill
    return out


# -- random transform classes ----------------------------------------------


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Randomly jitter brightness/contrast/saturation/hue (reference
    transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i]._apply_image(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = _np(img)
        hgt, wid = arr.shape[0], arr.shape[1]
        angle = random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate:
            tx = random.uniform(-self.translate[0], self.translate[0]) * wid
            ty = random.uniform(-self.translate[1], self.translate[1]) * hgt
        sc = random.uniform(*self.scale) if self.scale else 1.0
        sh = random.uniform(-self.shear, self.shear) \
            if isinstance(self.shear, (int, float)) and self.shear else 0.0
        return affine(arr, angle=angle, translate=(tx, ty), scale=sc,
                      shear=(sh, 0.0), fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() > self.prob:
            return _np(img)
        arr = _np(img)
        hgt, wid = arr.shape[0], arr.shape[1]
        d = self.distortion_scale

        def jitter(x, y):
            return (x + random.uniform(-d, d) * wid / 2,
                    y + random.uniform(-d, d) * hgt / 2)

        start = [(0, 0), (wid - 1, 0), (wid - 1, hgt - 1), (0, hgt - 1)]
        end = [jitter(*p) for p in start]
        return perspective(arr, start, end, fill=self.fill)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop resized to size (reference
    transforms.RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _np(img)
        hgt, wid = arr.shape[0], arr.shape[1]
        area = hgt * wid
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = math.exp(random.uniform(math.log(self.ratio[0]),
                                         math.log(self.ratio[1])))
            w = int(round(math.sqrt(target * ar)))
            h = int(round(math.sqrt(target / ar)))
            if 0 < w <= wid and 0 < h <= hgt:
                top = random.randint(0, hgt - h)
                left = random.randint(0, wid - w)
                return resize(crop(arr, top, left, h, w), self.size,
                              self.interpolation)
        return resize(center_crop(arr, min(hgt, wid)), self.size,
                      self.interpolation)


class RandomErasing(BaseTransform):
    """Randomly erase a rectangle (reference transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() > self.prob:
            return _np(img)
        arr = _np(img)
        hgt, wid = arr.shape[0], arr.shape[1]
        area = hgt * wid
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            h = int(round(math.sqrt(target * ar)))
            w = int(round(math.sqrt(target / ar)))
            if h < hgt and w < wid:
                top = random.randint(0, hgt - h)
                left = random.randint(0, wid - w)
                return erase(arr, top, left, h, w, self.value)
        return arr


__all__ += ["ColorJitter", "ContrastTransform", "SaturationTransform",
            "HueTransform", "RandomRotation", "RandomAffine",
            "RandomPerspective", "RandomResizedCrop", "RandomErasing",
            "to_grayscale", "adjust_brightness", "adjust_contrast",
            "adjust_saturation", "adjust_hue", "affine", "rotate",
            "perspective", "erase"]
