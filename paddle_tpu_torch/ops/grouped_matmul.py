"""K10: grouped matmul, the MoE expert GEMM (CUDA C++,
``csrc/grouped_matmul.cu``), beside its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas.py::grouped_matmul`` (:231-247): megablox
``gmm`` on the TPU, a gather-einsum fallback elsewhere. Row r of lhs
``[M, K]`` is multiplied by ``rhs[g(r)]`` of ``rhs [G, K, N]``, where the
rows are grouped in order by ``group_sizes [G]`` (empty groups allowed).
Rows past ``sum(group_sizes)`` take the last group, as the fallback's
``clip(#{g: r >= start_g} - 1)`` gives them; megablox assumes the sum is
M (ROADMAP C-ref-5). The result is in ``preferred_element_type`` (fp32 by
default).

The kernel has three instances (``csrc/grouped_matmul.cu``), and
:func:`kernel_for` is the dispatch: bf16 operands TMA can read go to the
Hopper instance (TMA and ``wgmma``), other bf16 operands to the
``mma.sync`` one, fp32 operands to the CUDA cores. The Hopper and fp32
instances walk a schedule of row tiles that a small kernel builds on the
card from the groups' ends (:func:`group_tile_schedule` is its plain
version): each group's tiles start at its first row, and the grid, the
most tiles any sizes need (:func:`max_row_tiles`), depends on the shapes
alone, so nothing is read back to the host. :func:`tile_passes` counts
the row-tile passes the schedule and the ``mma.sync`` instance's walk make.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from ._launches import costed, count

__all__ = ["grouped_matmul", "grouped_matmul_ref", "kernel_for",
           "group_tile_schedule", "max_row_tiles", "tile_passes"]

_IN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}     # in_f32
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # out_bf16
BM = 128                 # rows of a tile, every instance
# the C entry point of each instance
_ENTRIES = {"wgmma": "grouped_matmul_wgmma", "mma_sync": "grouped_matmul",
            "f32": "grouped_matmul"}


def kernel_for(dtype: torch.dtype, k: int, n: int, strides: Sequence[int],
               ptrs: Sequence[int]) -> str:
    """K10's dispatch for lhs and rhs of ``dtype``, depth ``k`` and width
    ``n``, with ``strides`` the operands' strides in elements other than
    their unit column strides (lhs rows, rhs groups, rhs rows) and ``ptrs``
    their data pointers: "wgmma" for bf16 operands TMA can read (k > 0, k
    and n multiples of 8, every stride a multiple of 8 elements, i.e. 16
    bytes, every pointer 16-byte aligned), "mma_sync" for other bf16
    operands, "f32" for fp32 ones. Raises ``ValueError`` for other
    dtypes."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"grouped_matmul: no kernel for {dtype}; the kernel "
                         f"takes bfloat16 and float32")
    tma = (k > 0 and k % 8 == 0 and n % 8 == 0
           and all(st % 8 == 0 for st in strides)
           and all(p % 16 == 0 for p in ptrs))
    return "wgmma" if tma else "mma_sync"


def max_row_tiles(m: int, g: int, bm: int = BM) -> int:
    """The grid's row tiles for M rows in G groups: ceil(m / bm) + g - 1,
    the most any group sizes summing to at most m need."""
    return -(-m // bm) + g - 1


def _group_rows(ends: Sequence[int], m: int) -> List[Tuple[int, int]]:
    """Each group's rows [s_g, e_g): e_g = min(ends[g], m) (m for the last
    group, which also takes the rows past the sum, C-ref-5), s_g the
    largest end before it."""
    rows, start = [], 0
    for g, end in enumerate(ends):
        e = m if g == len(ends) - 1 else min(max(int(end), 0), m)
        rows.append((start, max(start, e)))
        start = max(start, e)
    return rows


def group_tile_schedule(ends: Sequence[int], m: int,
                        bm: int = BM) -> List[Tuple[int, int, int]]:
    """The row tiles the Hopper and fp32 instances walk, as the card builds
    them from the groups' ends (cumulative sums of the sizes):
    ``(group, first row, end row)`` per tile, a group's tiles starting at
    its first row, bm rows apart, the last ending at the group's end;
    empty groups have none. Every row of 0..m-1 is in exactly one tile."""
    out = []
    for g, (s, e) in enumerate(_group_rows(ends, m)):
        out += [(g, r, min(r + bm, e)) for r in range(s, e, bm)]
    return out


def tile_passes(group_sizes: Sequence[int], m: int,
                bm: int = BM) -> Dict[str, int]:
    """Row-tile passes over the depth (each a K loop against one group's
    weights) for these group sizes: ``made``, by the schedule the Hopper
    and fp32 instances walk; ``walk``, by the ``mma.sync`` instance, whose
    tiles are aligned to M and pass once for every group they meet; and
    ``needed``, ceil(m / bm), the passes of one dense product of m rows."""
    ends, acc = [], 0
    for size in group_sizes:
        acc += int(size)
        ends.append(acc)
    rows = _group_rows(ends, m)
    walk = sum(sum(1 for s, e in rows if s < min(t + bm, m) and e > t
                   and e > s) for t in range(0, m, bm))
    return {"made": len(group_tile_schedule(ends, m, bm)), "walk": walk,
            "needed": -(-m // bm)}


def _check(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor):
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(
            f"grouped_matmul takes lhs [M, K] and rhs [G, K, N], got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    if tuple(group_sizes.shape) != (rhs.shape[0],) or rhs.shape[0] == 0:
        raise ValueError(
            f"group_sizes must be [G] with G = {rhs.shape[0]} > 0, got "
            f"{tuple(group_sizes.shape)}")
    if group_sizes.dtype.is_floating_point:
        raise ValueError(f"group_sizes must be integers, got "
                         f"{group_sizes.dtype}")


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor,
                       preferred_element_type: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain version of K10: one fp32 ``torch.matmul`` per non-empty group
    on its row slice (the last group also takes the rows past the sum),
    rounded once to ``preferred_element_type``. Reads the group sizes on
    the host; never gathers ``rhs`` per row."""
    _check(lhs, rhs, group_sizes)
    m, n, g = lhs.shape[0], rhs.shape[2], rhs.shape[0]
    out = torch.zeros((m, n), dtype=preferred_element_type,
                      device=lhs.device)
    start = 0
    for grp, size in enumerate(group_sizes.tolist()):
        end = m if grp == g - 1 else min(start + int(size), m)
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[grp].float()).to(preferred_element_type)
        start = max(start, end)
    return out


def _unit_cols(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(instance: str, lhs: torch.Tensor, rhs: torch.Tensor,
            ends: torch.Tensor, out: torch.Tensor,
            sched: Optional[torch.Tensor]) -> None:
    """One launch of ``instance`` on CUDA tensors (unit column strides,
    out contiguous), the schedule into ``sched`` (int32, 3 x
    :func:`max_row_tiles`; None for "mma_sync"); raises on a CUDA error."""
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    lib = _build.load("grouped_matmul")
    fn = getattr(lib, _ENTRIES[instance])
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 4 + [ll] * 3 + [i, i, p, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
                 out.data_ptr(), m, k, n, g, lhs.stride(0), rhs.stride(0),
                 rhs.stride(1), _IN_DTYPES[lhs.dtype],
                 _OUT_DTYPES[out.dtype],
                 None if sched is None else sched.data_ptr(), stream)
    _build.check(lib, err, _ENTRIES[instance])


def _gmm_cost(lhs, rhs, group_sizes, preferred_element_type=torch.float32):
    """K10's (FLOPs, bytes) on this run's group sizes (read back): 2 M K N
    operations; lhs read once, the weights of each non-empty group read
    once, out written once, the group sizes read once."""
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    live = int((group_sizes > 0).sum())
    return 2 * m * k * n, (m * k * lhs.element_size()
                           + live * k * n * rhs.element_size()
                           + m * n * preferred_element_type.itemsize
                           + g * group_sizes.element_size())


@costed(_gmm_cost)
def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor,
                   preferred_element_type: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """``out[r] = lhs[r] @ rhs[g(r)]`` by row group (K10): lhs [M, K] and
    rhs [G, K, N], both bf16 (tensor cores) or both fp32 (CUDA cores),
    group_sizes [G] integers, out [M, N] in
    ``preferred_element_type`` (fp32 or bf16), summed in fp32. The groups'
    offsets are a cumulative sum made on the card, and the Hopper and fp32
    instances' tile schedule is built there too: nothing is read back."""
    _check(lhs, rhs, group_sizes)
    if lhs.device.type == "cpu":
        return grouped_matmul_ref(lhs, rhs, group_sizes,
                                  preferred_element_type)
    devs = {t.device for t in (lhs, rhs, group_sizes)}
    if len(devs) != 1 or lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for devices {devs}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in _IN_DTYPES:
        raise ValueError(f"grouped_matmul kernel takes lhs and rhs both bf16 "
                         f"or both fp32, got {lhs.dtype}, {rhs.dtype}")
    if preferred_element_type not in _OUT_DTYPES:
        raise ValueError(f"grouped_matmul kernel writes fp32 or bf16, got "
                         f"{preferred_element_type}")
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    out = torch.empty((m, n), dtype=preferred_element_type,
                      device=lhs.device)
    if out.numel() == 0:      # an empty grid is not a launch
        return out
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    lhs, rhs = _unit_cols(lhs), _unit_cols(rhs)
    instance = kernel_for(lhs.dtype, k, n, (lhs.stride(0), rhs.stride(0),
                                            rhs.stride(1)),
                          (lhs.data_ptr(), rhs.data_ptr()))
    sched = (None if instance == "mma_sync" else torch.empty(
        3 * max_row_tiles(m, g), dtype=torch.int32, device=lhs.device))
    _launch(instance, lhs, rhs, ends, out, sched)
    count(grouped_matmul)
    return out


grouped_matmul.launches = 0
