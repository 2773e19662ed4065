"""ctypes binding to the shared C++ host planner (`csrc/native.cpp`).

The port's own binding, built with the flags of `csrc/Makefile` into the
gitignored `occuseg_tpu_torch/build/` directory (nothing is written into
`csrc/`). There is no NumPy fallback: if the library cannot be built or
loaded, the first call raises.

Only the entry points the port's paths need are bound: the planner's and
the supervoxel segmentation of data preparation. ctypes
releases the GIL for the duration of each call, so plans build in threads
(`native/pool.py`). Two of them get input checks in front of the C code, which trusts its callers:
`plan_neighbor_map_derived` indexes a 3x3x3 table by the offsets and leaves
cells unset on a duplicate-offset list, and `gather_rows` reads
`src[perm[i]]` without a bounds check.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from occuseg_tpu_torch._build import REPO_DIR, build_shared_library

_SOURCE = os.path.join(REPO_DIR, "csrc", "native.cpp")
# csrc/Makefile: CXXFLAGS (the build adds -shared to the link)
_CXX = ("g++",)
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
          "-fopenmp")

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the planner library; raises on failure."""
    lib = ctypes.CDLL(build_shared_library("occ_native", [_SOURCE], _CXX,
                                           _FLAGS))
    lib.voxelize_points.restype = ctypes.c_int32
    lib.voxelize_points.argtypes = [_i32p, ctypes.c_int32, _i32p]
    lib.plan_voxelize.restype = ctypes.c_int32
    lib.plan_voxelize.argtypes = [_i32p, ctypes.c_int32, ctypes.c_int32,
                                  _i64p, _i32p, _i32p]
    lib.plan_neighbor_map.restype = None
    lib.plan_neighbor_map.argtypes = [_i64p, _i32p, ctypes.c_int32,
                                      ctypes.c_int32, _i32p,
                                      ctypes.c_int32, _i32p]
    lib.plan_neighbor_map_derived.restype = ctypes.c_int32
    lib.plan_neighbor_map_derived.argtypes = [
        _i32p, ctypes.c_int32, ctypes.c_int32, _i32p, ctypes.c_int32,
        _i32p, _i32p, _i32p, ctypes.c_int32, _i32p]
    lib.plan_downsample.restype = ctypes.c_int32
    lib.plan_downsample.argtypes = [_i64p, _i32p, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32,
                                    _i64p, _i32p, _i32p, _i32p]
    lib.plan_chunks.restype = ctypes.c_int32
    lib.plan_chunks.argtypes = [_i32p, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32,
                                _i32p, _i32p, _i32p, ctypes.c_int32]
    lib.segment_supervoxels.restype = ctypes.c_int32
    lib.segment_supervoxels.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, _i32p]
    lib.gather_rows.restype = None
    lib.gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, _i64p,
                                ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_char_p]
    return lib


def set_threads(n: int) -> None:
    """Give the planner's OpenMP loops that the calling thread starts a
    team of `n` threads (OpenMP's `omp_set_num_threads`, found through
    the library's own link to the OpenMP runtime: a setting of the calling
    thread alone, kept for its later calls)."""
    load().omp_set_num_threads(ctypes.c_int(int(n)))


def threads() -> int:
    """The team the calling thread's next OpenMP loop would start
    (`omp_get_max_threads`)."""
    return int(load().omp_get_max_threads())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def voxelize_points(coords: np.ndarray) -> np.ndarray:
    """Point -> voxel id [P] int32 by hash dedup of the (b, z, y, x) rows
    in first-seen order (-1 for pad rows with b < 0)."""
    c = _i32(coords)
    out = np.empty(c.shape[0], np.int32)
    load().voxelize_points(_ptr(c, ctypes.c_int32), c.shape[0],
                           _ptr(out, ctypes.c_int32))
    return out


def plan_voxelize(point_coords: np.ndarray, cap: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Level 0 from padded point coords [P,4] (b,z,y,x; -1 rows ignored):
    (keys [cap] int64 Morton, coords [cap,4] int32, p2v [P] int32,
    num_active)."""
    pts = _i32(point_coords)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"point coords must be [P,4], got {pts.shape}")
    P = pts.shape[0]
    keys = np.empty(cap, np.int64)
    coords = np.empty((cap, 4), np.int32)
    p2v = np.empty(P, np.int32)
    n = load().plan_voxelize(_ptr(pts, ctypes.c_int32), P, cap,
                             _ptr(keys, ctypes.c_int64),
                             _ptr(coords, ctypes.c_int32),
                             _ptr(p2v, ctypes.c_int32))
    return keys, coords, p2v, int(n)


def plan_neighbor_map(keys: np.ndarray, coords: np.ndarray, num_active: int,
                      offsets: np.ndarray) -> np.ndarray:
    """Submanifold neighbor map [cap, K] by hash probes (-1 missing)."""
    keys = np.ascontiguousarray(keys, np.int64)
    coords = _i32(coords)
    offs = _i32(offsets)
    cap, K = keys.shape[0], offs.shape[0]
    nbr = np.empty((cap, K), np.int32)
    load().plan_neighbor_map(_ptr(keys, ctypes.c_int64),
                             _ptr(coords, ctypes.c_int32), cap, num_active,
                             _ptr(offs, ctypes.c_int32), K,
                             _ptr(nbr, ctypes.c_int32))
    return nbr


def plan_neighbor_map_derived(coords: np.ndarray, num_active: int,
                              offsets: np.ndarray, up: np.ndarray,
                              child: np.ndarray, nbr_coarse: np.ndarray
                              ) -> Optional[np.ndarray]:
    """Fine-level neighbor map derived from the coarse level's map, or None
    when the C precondition check declines (caller probes instead).

    Raises ValueError on a duplicate offset: the C code fills a 3x3x3
    offset table from the list, and a duplicate leaves a cell unset that
    it then reads."""
    offs = _i32(offsets)
    if len(np.unique(offs, axis=0)) != offs.shape[0]:
        raise ValueError("plan_neighbor_map_derived: duplicate offsets")
    coords, up, child = _i32(coords), _i32(up), _i32(child)
    nbr_coarse = _i32(nbr_coarse)
    cap, K = coords.shape[0], offs.shape[0]
    if up.shape != (cap, 8) or child.shape[1] != 8 \
            or nbr_coarse.shape[0] != child.shape[0]:
        raise ValueError("plan_neighbor_map_derived: inconsistent shapes")
    nbr = np.empty((cap, K), np.int32)
    rc = load().plan_neighbor_map_derived(
        _ptr(coords, ctypes.c_int32), cap, num_active,
        _ptr(offs, ctypes.c_int32), K, _ptr(up, ctypes.c_int32),
        _ptr(child, ctypes.c_int32), _ptr(nbr_coarse, ctypes.c_int32),
        nbr_coarse.shape[1], _ptr(nbr, ctypes.c_int32))
    return nbr if rc == 0 else None


def plan_downsample(keys: np.ndarray, coords: np.ndarray, num_active: int,
                    cap_c: int):
    """Stride-2 coarse level + transition maps: (coarse keys [cap_c],
    coarse coords [cap_c,4], child [cap_c,8], up [cap,8], coarse count)."""
    keys = np.ascontiguousarray(keys, np.int64)
    coords = _i32(coords)
    cap = keys.shape[0]
    ckeys = np.empty(cap_c, np.int64)
    ccoords = np.empty((cap_c, 4), np.int32)
    child = np.empty((cap_c, 8), np.int32)
    up = np.empty((cap, 8), np.int32)
    nc = load().plan_downsample(
        _ptr(keys, ctypes.c_int64), _ptr(coords, ctypes.c_int32), cap,
        num_active, cap_c, _ptr(ckeys, ctypes.c_int64),
        _ptr(ccoords, ctypes.c_int32), _ptr(child, ctypes.c_int32),
        _ptr(up, ctypes.c_int32))
    return ckeys, ccoords, child, up, int(nc)


def plan_chunks(nbr: np.ndarray, M: int, U: int):
    """Chunk rulebook of a map [cap, K]: (in_idx [C,U], lidx [C,K,M]) or
    (None, max_unique) when some chunk references more than U rows."""
    nbr = _i32(nbr)
    cap, K = nbr.shape
    C = cap // M
    in_idx = np.empty((C, U), np.int32)
    lidx = np.empty((C, K, M), np.int32)
    max_uniq = load().plan_chunks(_ptr(nbr, ctypes.c_int32), cap, K, M, U,
                                  _ptr(in_idx, ctypes.c_int32),
                                  _ptr(lidx, ctypes.c_int32), None, 0)
    if max_uniq > U:
        return None, int(max_uniq)
    return in_idx, lidx


def segment_supervoxels(points: np.ndarray, feat: np.ndarray, cell: float,
                        k_thresh: float, min_size: int) -> np.ndarray:
    """Felzenszwalb-Huttenlocher segmentation of points [N, 3] with edge
    features feat [N, F] over the `cell`-sized voxel adjacency: [N] int32
    segment ids, dense from 0 in first-seen order."""
    pts = np.ascontiguousarray(points, np.float32)
    ft = np.ascontiguousarray(feat, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N,3], got {pts.shape}")
    if ft.ndim != 2 or ft.shape[0] != pts.shape[0]:
        raise ValueError(f"feat must be [N,F] with N={pts.shape[0]}, got "
                         f"{ft.shape}")
    if not cell > 0:
        raise ValueError(f"cell must be positive, got {cell}")
    n = pts.shape[0]
    out = np.empty(n, np.int32)
    load().segment_supervoxels(_ptr(pts, ctypes.c_float),
                               _ptr(ft, ctypes.c_float), n, ft.shape[1],
                               cell, k_thresh, min_size,
                               _ptr(out, ctypes.c_int32))
    return out


def gather_rows(src: np.ndarray, perm: np.ndarray, fill) -> np.ndarray:
    """out[i] = src[perm[i]], or `fill` where perm[i] < 0.

    Raises IndexError when an index is past the end of `src`: the C gather
    copies whatever memory the index points at."""
    src = np.ascontiguousarray(src)
    perm = np.ascontiguousarray(perm, np.int64)
    if perm.ndim != 1:
        raise ValueError(f"perm must be 1-D, got shape {perm.shape}")
    if perm.size and int(perm.max()) >= src.shape[0]:
        raise IndexError(f"gather_rows: index {int(perm.max())} out of "
                         f"range for {src.shape[0]} rows")
    n = perm.shape[0]
    out = np.empty((n,) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    fill_row = np.full(src.shape[1:], fill, src.dtype).tobytes()
    load().gather_rows(src.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p),
                       perm.ctypes.data_as(_i64p), n, row_bytes, fill_row)
    return out
