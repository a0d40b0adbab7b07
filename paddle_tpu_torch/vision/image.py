"""The image backend switch and ``image_load`` (port of
``paddle_tpu/vision/image.py``): ``"pil"`` (the default) or ``"cv2"``; a
backend whose package is missing raises when it is set or used."""
from __future__ import annotations

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKEND = ["pil"]


def set_image_backend(backend: str):
    if backend not in ("pil", "cv2"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2'], but got {backend}")
    if backend == "cv2":
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ModuleNotFoundError(
                "cv2 backend requires opencv-python, which is not bundled "
                "in this image") from e
    _BACKEND[0] = backend


def get_image_backend() -> str:
    return _BACKEND[0]


def image_load(path: str, backend=None):
    """Load an image via the active backend (reference image.py
    image_load). Returns a PIL Image (pil) or ndarray (cv2)."""
    backend = backend or _BACKEND[0]
    if backend == "cv2":
        import cv2

        return cv2.imread(path)
    from PIL import Image

    return Image.open(path)
