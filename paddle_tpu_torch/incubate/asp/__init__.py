"""ASP, automatic structured (n:m) sparsity (port of
``paddle_tpu/incubate/asp``; reference python/paddle/incubate/asp/:
utils.py's mask algorithms at get_mask_1d:179 / get_mask_2d_greedy:313 /
get_mask_2d_best:426, asp.py's ASPHelper prune_model/decorate).

The mask algorithms and their checks are the JAX package's numpy, copied
as they are, so the masks are the same bit for bit. ``prune_model``
multiplies every supported weight (a linear's or a convolution's, never a
bias or a norm) by its mask over a model's ``named_parameters``, the
port's ``Layer`` and any ``torch.nn.Module`` alike, and keeps the masks on
the weights' device; ``decorate`` multiplies them in again after every
optimizer step, so the n:m structure holds while the model trains. The
masked weights run dense, as in the JAX package: Hopper's 2:4 sparse
tensor cores are a feature the JAX package lacks, and out of scope here.
"""
from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers", "create_mask",
           "check_sparsity", "MaskAlgo", "CheckMethod"]


def _numpy(x) -> np.ndarray:
    """A tensor (any dtype, any device) or an array as numpy; bf16 goes
    through fp32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class MaskAlgo(Enum):
    MASK_1D = "get_mask_1d"
    MASK_2D_GREEDY = "get_mask_2d_greedy"
    MASK_2D_BEST = "get_mask_2d_best"


class CheckMethod(Enum):
    CHECK_1D = "check_mask_1d"
    CHECK_2D = "check_mask_2d"

    @staticmethod
    def get_checking_method(mask_algo: MaskAlgo):
        return (CheckMethod.CHECK_1D if mask_algo == MaskAlgo.MASK_1D
                else CheckMethod.CHECK_2D)


def calculate_density(x) -> float:
    """Fraction of nonzeros (reference utils.py:81)."""
    a = _numpy(x)
    return float(np.count_nonzero(a)) / a.size


def _reshape_1d(mat: np.ndarray, m: int):
    pad = (m - mat.shape[1] % m) % m
    padded = np.zeros((mat.shape[0], mat.shape[1] + pad), mat.dtype)
    padded[:, :mat.shape[1]] = mat
    return padded.reshape(-1, m), padded.shape


def get_mask_1d(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """Keep the n largest-|.| of every m consecutive elements per row
    (reference utils.py:179)."""
    rows, shape = _reshape_1d(mat, m)
    mask = np.zeros_like(rows)
    idx = np.argsort(np.abs(rows), axis=1)[:, -n:]
    np.put_along_axis(mask, idx, 1.0, axis=1)
    return mask.reshape(shape)[:, :mat.shape[1]]


def check_mask_1d(mat: np.ndarray, n: int, m: int) -> bool:
    rows, _ = _reshape_1d(np.asarray(mat), m)
    return bool(np.all(np.count_nonzero(rows, axis=1) <= n))


def _reshape_2d(mat: np.ndarray, m: int):
    pad_r = (m - mat.shape[0] % m) % m
    pad_c = (m - mat.shape[1] % m) % m
    padded = np.zeros((mat.shape[0] + pad_r, mat.shape[1] + pad_c),
                      mat.dtype)
    padded[:mat.shape[0], :mat.shape[1]] = mat
    h, w = padded.shape
    blocks = padded.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3)
    return blocks.reshape(-1, m, m), padded.shape


def _unreshape_2d(blocks: np.ndarray, padded_shape, orig_shape, m: int):
    h, w = padded_shape
    out = blocks.reshape(h // m, w // m, m, m).transpose(0, 2, 1, 3)
    return out.reshape(h, w)[:orig_shape[0], :orig_shape[1]]


def get_mask_2d_greedy(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """Greedy n:m along rows AND columns of each m x m block (reference
    utils.py:313)."""
    blocks, pshape = _reshape_2d(mat, m)
    masks = np.zeros_like(blocks)
    for bi, block in enumerate(np.abs(blocks)):
        order = np.argsort(block.ravel())[::-1]
        row_counts = np.zeros(m, np.int64)
        col_counts = np.zeros(m, np.int64)
        for flat in order:
            r, c = divmod(int(flat), m)
            if row_counts[r] < n and col_counts[c] < n:
                masks[bi, r, c] = 1.0
                row_counts[r] += 1
                col_counts[c] += 1
    return _unreshape_2d(masks, pshape, mat.shape, m)


_PATTERN_CACHE: Dict = {}


def _compute_valid_2d_patterns(n: int, m: int) -> np.ndarray:
    """All m x m 0/1 patterns with exactly n per row and per column
    (reference utils.py:385)."""
    key = (n, m)
    if key in _PATTERN_CACHE:
        return _PATTERN_CACHE[key]
    row_patterns = [p for p in itertools.product([0, 1], repeat=m)
                    if sum(p) == n]
    valid = []
    for combo in itertools.product(row_patterns, repeat=m):
        arr = np.asarray(combo)
        if np.all(arr.sum(axis=0) == n):
            valid.append(arr)
    pats = np.asarray(valid, np.float64)
    _PATTERN_CACHE[key] = pats
    return pats


def get_mask_2d_best(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """Exhaustive best n:m 2-D pattern per block (reference utils.py:426)."""
    blocks, pshape = _reshape_2d(mat, m)
    pats = _compute_valid_2d_patterns(n, m)          # [P, m, m]
    scores = np.einsum("bij,pij->bp", np.abs(blocks), pats)
    best = pats[np.argmax(scores, axis=1)]
    return _unreshape_2d(best.astype(mat.dtype), pshape, mat.shape, m)


def check_mask_2d(mat: np.ndarray, n: int, m: int) -> bool:
    blocks, _ = _reshape_2d(np.asarray(mat), m)
    nz = blocks != 0
    return bool(np.all(nz.sum(axis=1) <= n) and np.all(nz.sum(axis=2) <= n))


def create_mask(tensor, func_name=MaskAlgo.MASK_1D, n: int = 2, m: int = 4):
    """Mask for a (possibly >2-D) tensor (reference utils.py:480): shaped
    over the last two dims, others folded into rows; numpy, in the
    tensor's dtype (fp32 for a bf16 tensor)."""
    a = _numpy(tensor)
    dtype = a.dtype
    shape = a.shape
    if a.ndim == 1:
        mat = a.reshape(1, -1)
    elif a.ndim == 2:
        mat = a
    else:
        mat = a.reshape(-1, shape[-1])
    fn = globals()[func_name.value if isinstance(func_name, MaskAlgo)
                   else func_name]
    mask = fn(mat.astype(np.float64), n, m)
    return mask.reshape(shape).astype(dtype)


def check_sparsity(tensor, func_name=CheckMethod.CHECK_1D, n: int = 2,
                   m: int = 4) -> bool:
    a = _numpy(tensor)
    mat = a.reshape(-1, a.shape[-1]) if a.ndim != 2 else a
    fn = globals()[func_name.value if isinstance(func_name, CheckMethod)
                   else func_name]
    return fn(mat, n, m)


# ---------------------------------------------------------------------------
# ASPHelper: model-level pruning and optimizer decoration (asp.py parity)
# ---------------------------------------------------------------------------

# the mask and exclusion state lives ON the model object: an id()-keyed
# registry would leak masks for the process lifetime and could hand a
# recycled id the previous model's masks
_MASK_ATTR = "_asp_masks"
_EXCL_ATTR = "_asp_excluded"


def _supported(name: str, param) -> bool:
    # reference supported_layer_list: fc/linear/conv weights; biases and
    # norms are never pruned
    if param.dim() < 2:
        return False
    return "weight" in name.split(".")[-1]


def set_excluded_layers(model, param_names):
    """Exclude sublayer/param names from pruning (reference asp.py:121)."""
    excl = getattr(model, _EXCL_ATTR, None)
    if excl is None:
        excl = set()
        object.__setattr__(model, _EXCL_ATTR, excl)
    excl.update(param_names)


def reset_excluded_layers(model=None):
    if model is not None and hasattr(model, _EXCL_ATTR):
        getattr(model, _EXCL_ATTR).clear()


@torch.no_grad()
def prune_model(model, n: int = 2, m: int = 4,
                mask_algo: str = "mask_1d", with_mask: bool = True):
    """Apply n:m masks to every supported weight (reference asp.py:204).
    Returns {param_name: numpy mask}; with ``with_mask`` the masks stay on
    the model, on the weights' device, for :func:`decorate`."""
    algo = {"mask_1d": MaskAlgo.MASK_1D,
            "mask_2d_greedy": MaskAlgo.MASK_2D_GREEDY,
            "mask_2d_best": MaskAlgo.MASK_2D_BEST}[mask_algo]
    excluded = getattr(model, _EXCL_ATTR, set())
    params = [(name, p) for name, p in model.named_parameters()
              if _supported(name, p) and not any(e in name for e in excluded)]
    # the masks are numpy on the host, one weight a worker thread (numpy's
    # sorts release the GIL); each is the same whatever thread computes it
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        host = list(ex.map(lambda np_: create_mask(np_[1], func_name=algo,
                                                   n=n, m=m), params))
    masks = {}
    device_masks = {}
    for (name, p), mask in zip(params, host):
        # masks stay on the device: the per-step re-masking in decorate()
        # is value * mask with no host round trip
        mask_dev = torch.from_numpy(mask).to(device=p.device, dtype=p.dtype)
        p.mul_(mask_dev)
        masks[name] = mask
        device_masks[name] = mask_dev
    if with_mask:
        object.__setattr__(model, _MASK_ATTR, device_masks)
    return masks


class OptimizerWithSparsityGuarantee:
    """Re-applies the pruning masks after every step so training keeps the
    n:m structure (reference asp.py ASPHelper._decorate); everything else
    forwards to the wrapped optimizer."""

    def __init__(self, optimizer, model):
        self._inner_opt = optimizer
        self._model = model

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        masks = getattr(self._model, _MASK_ATTR, {})
        if not masks:
            return
        for name, p in self._model.named_parameters():
            mask = masks.get(name)
            if mask is not None:
                p.mul_(mask)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)

    def state_dict(self) -> Dict[str, Any]:
        return self._inner_opt.state_dict()

    def set_state_dict(self, state_dict):
        self._inner_opt.set_state_dict(state_dict)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)


def decorate(optimizer, model=None):
    """Wrap the optimizer with the sparsity guarantee (reference
    asp.py:160). ``model`` binds the mask set (the eager API needs it
    explicitly: there is no global program to look it up from)."""
    if model is None:
        raise ValueError(
            "decorate() needs the model the masks were created for: "
            "asp.decorate(optimizer, model)")
    return OptimizerWithSparsityGuarantee(optimizer, model)
