"""Weight-gradient reduction of the backward kernels: CUDA kernel and its
plain PyTorch version.

Part of the port of ``tacotron_multispeaker_tpu/ops/gru_scan.py``
``_bigru_scan_bwd_pallas`` and ``ops/teacher_decoder.py``
``_teacher_decoder_bwd_pallas``.  Those Pallas kernels add each step's
weight gradient ``dot_tn(a_t, g_t)`` (both factors rounded to the compute
dtype, f32 sums) and bias gradient ``sum(g_t, 0)`` into VMEM accumulators.
On the card the sequential backward kernels stream the per-step factors out
instead, and this op reduces them over every step and batch row at once:

    C = sum_m round(A[m])^T round(G[m])        (f32)
    bias = sum_m G[m]                          (f32, unrounded)

Each problem is a pair of 3-D views ``a`` [Mo, Mi, K] and ``g`` [Mo, Mi, N]
(rows m = (o, i); any strides, unit stride in the last dim), so a direction
or a column slice of a stream needs no copy.  :func:`wgrad` takes a list of
problems and reduces them all in ONE launch (a grouped product: the grid
walks the output tiles of every problem, the tile index fastest, over row
ranges).

The launch takes one of two routes of ``csrc/wgrad.cu`` by one rule
(:func:`route`): the tensor cores (``"mma"``) when the compute dtype is
bfloat16 and every factor's rows start on 16-byte boundaries and are whole
16-byte vectors wide; the FMA kernel (``"fma"``) otherwise.  Each route
counts its own launches (:data:`launches`, :data:`fma_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import struct
from typing import NamedTuple, Sequence

import torch

from . import cuda_build

# launches of the CUDA kernel by route (the plain version does not count)
launches = 0          # tensor cores
fma_launches = 0      # FMA kernel

_MAX_PROBLEMS = 24    # csrc/wgrad.cu MAX_PROBLEMS
# (output tile edge, rows a stage) of each route: csrc/wgrad.cu TC_TILE,
# TC_BM and TILE, BM
_TILE = {"mma": 128, "fma": 64}
_BM = {"mma": 64, "fma": 32}
_TARGET_BLOCKS = 528  # FMA route: four blocks per SM of an H100 (132 SMs)
_MIN_ROWS = 256       # fewest rows a range takes (FMA: 8 stages of 32; mma: 4 of 64)
# mma route: a range's partial tile (written, then read back by the second
# pass) costs about as much as this many rows of f32 factors of a tile
_PART_ROWS = 128
H100_SMS = 132


def wgrad_reference(problems: Sequence[tuple], cdt: torch.dtype) -> list:
    """Plain version: ``problems`` is a sequence of (a, g, with_bias);
    returns [(C [K, N] f32, bias [N] f32 or None)]."""
    rnd = lambda x: x.to(cdt).float()
    out = []
    for a, g, with_bias in problems:
        a2 = rnd(a.reshape(-1, a.shape[-1]))
        g2 = g.reshape(-1, g.shape[-1]).float()
        c = a2.t() @ rnd(g2)
        out.append((c, g2.sum(0) if with_bias else None))
    return out


class _Problem(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("a_so", ctypes.c_longlong), ("a_si", ctypes.c_longlong),
                ("g_so", ctypes.c_longlong), ("g_si", ctypes.c_longlong),
                ("m_outer", ctypes.c_int), ("m_inner", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("a_bf16", ctypes.c_int), ("g_bf16", ctypes.c_int)]


# the same layout packed in one call a problem (the wrapper's host time)
_PACK = struct.Struct("<4Q4q6i")
assert _PACK.size == ctypes.sizeof(_Problem)

_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


class _Shape(NamedTuple):
    """What the route and the plan read of one problem."""
    rows: int                 # Mo * Mi
    K: int
    N: int
    aligned: bool             # both factors keep the tensor-core route's rule


def _vectors_aligned(ptr: int, stride: tuple, width: int, es: int) -> bool:
    """The tensor-core route's rule for one factor: its rows start on
    16-byte boundaries (address and both row strides multiples of 16
    bytes) and are whole 16-byte vectors wide."""
    return (ptr % 16 == 0 and (stride[0] * es) % 16 == 0 and (stride[1] * es) % 16 == 0
            and (width * es) % 16 == 0)


def _shapes(problems, cdt):
    """Checks ``problems`` → (their device, a :class:`_Shape` each)."""
    if cdt not in _ESIZE:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    dev = problems[0][0].device if problems else None
    shapes = []
    for n, (a, g, _) in enumerate(problems):
        ash, gsh = a.shape, g.shape
        if len(ash) != 3 or len(gsh) != 3 or ash[:2] != gsh[:2]:
            raise ValueError(f"problem {n}: a [Mo, Mi, K] and g [Mo, Mi, N] must share "
                             f"their rows, got {tuple(ash)} and {tuple(gsh)}")
        aligned = True
        for name, t, width in (("a", a, ash[2]), ("g", g, gsh[2])):
            if t.device != dev:
                raise ValueError(f"problem {n}: {name} is on {t.device}, not {dev}")
            es = _ESIZE.get(t.dtype)
            if es is None:
                raise TypeError(f"problem {n}: {name} must be float32 or bfloat16, "
                                f"got {t.dtype}")
            aligned = aligned and _vectors_aligned(t.data_ptr(), t.stride(), width, es)
        shapes.append(_Shape(ash[0] * ash[1], ash[2], gsh[2], aligned))
    return dev, shapes


def _route(shapes, cdt) -> str:
    return "mma" if cdt == torch.bfloat16 and all(s.aligned for s in shapes) else "fma"


def route(problems: Sequence[tuple], cdt: torch.dtype) -> str:
    """The launch's route: ``"mma"`` (tensor cores) when ``cdt`` is
    bfloat16 and every factor of every problem keeps the 16-byte rule of
    :func:`_vectors_aligned`, else ``"fma"``."""
    return _route(_shapes(list(problems), cdt)[1], cdt)


class Plan(NamedTuple):
    route: str
    tile: int                 # output tile edge (K and N)
    splits: int               # row ranges
    tiles: tuple              # (tiles along K, tiles along N) of each problem


def _range_rows(rows: int, splits: int, bm: int) -> int:
    """Rows of a range (the last may hold fewer): ceil(rows / splits)
    rounded up to whole stages of ``bm`` rows, as the kernel cuts them."""
    per = -(-rows // splits)
    return -(-per // bm) * bm


@functools.lru_cache(maxsize=256)
def _mma_splits(n_tiles: int, rows: int, n_sm: int) -> int:
    """Row ranges of the tensor-core route: one block an SM, so the blocks
    run in waves of ``n_sm``; the fewest ranges that minimise the waves
    times a range's rows plus the partials' cost (``_PART_ROWS`` a block,
    none for one range), over at most four waves' worth of ranges."""
    best, best_cost = 1, None
    for s in range(1, max(1, min(rows // _MIN_ROWS, 4 * n_sm, 65535)) + 1):
        waves = -(-n_tiles * s // n_sm)
        cost = waves * _range_rows(rows, s, _BM["mma"]) + (
            _PART_ROWS * n_tiles * s / n_sm if s > 1 else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _fma_splits(n_tiles: int, rows: int) -> int:
    """Row ranges of the FMA route: enough blocks to fill the card, each
    range at least _MIN_ROWS rows of the smallest problem."""
    return int(max(1, min(-(-_TARGET_BLOCKS // max(n_tiles, 1)), rows // _MIN_ROWS, 65535)))


def plan(problems: Sequence[tuple], cdt: torch.dtype, n_sm: int = H100_SMS,
         fma: bool = False, splits: int | None = None) -> Plan:
    """The launch plan of ``problems``, a pure function of their shapes,
    strides, dtypes and alignment and of the card's SM count: the route
    (:func:`route`, or the FMA kernel with ``fma``), the tile, the row
    ranges (or ``splits``) and each problem's tiles."""
    return _plan(_shapes(list(problems), cdt)[1], cdt, n_sm, fma, splits)


def _plan(shapes, cdt, n_sm, fma, splits) -> Plan:
    r = "fma" if fma else _route(shapes, cdt)
    t = _TILE[r]
    tiles = tuple((-(-s.K // t), -(-s.N // t)) for s in shapes)
    n_tiles = sum(tk * tn for tk, tn in tiles)
    rows = min(s.rows for s in shapes)
    if splits is None:
        splits = _mma_splits(n_tiles, rows, n_sm) if r == "mma" else _fma_splits(n_tiles, rows)
    if not 1 <= splits <= 65535:
        raise ValueError(f"wgrad: {splits} row ranges, not in [1, 65535]")
    return Plan(r, t, int(splits), tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wgrad(problems: Sequence[tuple], cdt: torch.dtype, fma: bool = False,
          splits: int | None = None) -> list:
    """All weight (and bias) gradients of ``problems`` (see the module
    docstring); CPU tensors take the plain version, CUDA tensors one launch
    of ``csrc/wgrad.cu`` on the route of :func:`plan` (``fma`` forces the
    FMA kernel and ``splits`` the row ranges, for comparisons on the card)."""
    problems = list(problems)
    dev, shapes = _shapes(problems, cdt)
    if not problems:
        return []
    if dev.type == "cpu":
        return wgrad_reference(problems, cdt)
    if dev.type != "cuda":
        raise ValueError(f"wgrad runs on cpu or cuda, not {dev}")
    if len(problems) > _MAX_PROBLEMS:
        raise ValueError(f"wgrad kernel: {len(problems)} problems > {_MAX_PROBLEMS}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = _plan(shapes, cdt, _sm_count(index), fma, splits)
    out, descs = [], []
    for n, ((a, g, with_bias), sh) in enumerate(zip(problems, shapes)):
        (a_so, a_si, a_s), (g_so, g_si, g_s) = a.stride(), g.stride()
        if a_s != 1 or g_s != 1:
            raise ValueError(f"problem {n}: the last dim of a and g must be contiguous")
        if sh.rows >= 2 ** 31 - 256 or sh.K >= 2 ** 31 or sh.N >= 2 ** 31:
            raise ValueError(f"problem {n}: sizes must fit in 32 bits")
        c = torch.empty((sh.K, sh.N), dtype=torch.float32, device=dev)
        bias = torch.empty((sh.N,), dtype=torch.float32, device=dev) if with_bias else None
        out.append((c, bias))
        descs.append(_PACK.pack(a.data_ptr(), g.data_ptr(), c.data_ptr(),
                                bias.data_ptr() if with_bias else 0, a_so, a_si, g_so, g_si,
                                a.shape[0], a.shape[1], sh.K, sh.N,
                                int(a.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16)))
    # the partials of every range: [K, N] then [N] a problem (csrc/wgrad.cu)
    n_part = sum(sh.K * sh.N + sh.N for sh in shapes) * p.splits if p.splits > 1 else 0
    scratch = torch.empty((n_part,), dtype=torch.float32, device=dev)
    arr = b"".join(descs)
    lib = _lib()
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream().cuda_stream
        if p.route == "mma":
            err = lib.wgrad_tc_launch(arr, len(descs), p.splits, scratch.data_ptr(), stream)
        else:
            err = lib.wgrad_launch(arr, len(descs), p.splits, scratch.data_ptr(),
                                   int(cdt == torch.bfloat16), stream)
    cuda_build.check(err, f"wgrad kernel launch ({p.route} route)")
    global launches, fma_launches
    if p.route == "mma":
        launches += 1
    else:
        fma_launches += 1
    return out


def tc_smem_bytes() -> int:
    """Shared memory of the tensor-core kernel's block (csrc/wgrad.cu
    TC_SMEM): 1 KB of alignment, four stages of A and G in bf16 (TC_BM rows
    of 128 columns each), 4 KB of bias sums and eight mbarriers."""
    bm, tile = _BM["mma"], _TILE["mma"]
    return 1024 + 4 * 2 * bm * tile * 2 + 8 * tile * 4 + 8 * 8


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("wgrad")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wgrad_launch.argtypes = [p, i, i, p, i, p]
        lib.wgrad_launch.restype = i
        lib.wgrad_tc_launch.argtypes = [p, i, i, p, p]
        lib.wgrad_tc_launch.restype = i
        lib.wgrad_tc_smem_bytes.argtypes = []
        lib.wgrad_tc_smem_bytes.restype = ctypes.c_longlong
        lib.wgrad_tc_blocks_per_sm.argtypes = []
        lib.wgrad_tc_blocks_per_sm.restype = i
        lib._typed = True
    return lib
