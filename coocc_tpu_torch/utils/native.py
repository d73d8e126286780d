"""ctypes bindings for the native host-preprocessing library.

Counterpart of coocc_tpu/utils/native.py. The C++ source is the port's own
copy, csrc/host/coocc_host.cpp (byte-equal to the JAX package's
native/coocc_host.cpp); it is built with g++ at first use into
coocc_tpu_torch/_build/ (listed in .gitignore), named by the hash of the
source, and a failed build raises. Each entry point's numpy version is its
plain version, reached only by an explicit `impl="numpy"`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "coocc_host.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcoocc_host-{digest}.so")


def _build(lib: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           "csrc/host/coocc_host.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for csrc/host/coocc_host.cpp "
                           f"(rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
                ctypes.c_int64)
            i64 = ctypes.c_int64
            lib.zbuffer_depth.restype = None
            lib.zbuffer_depth.argtypes = [f, i64, i64, i64, f]
            lib.majority_vote.restype = None
            lib.majority_vote.argtypes = [i, i, i64, i64, i64, i64, i]
            lib.voxelize_mean.restype = i64
            lib.voxelize_mean.argtypes = [f, i64, i64, f, f, i64, i64, i64,
                                          i64, i64, i, f]
            _lib = lib
    return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_impl(impl: str) -> None:
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl {impl!r}: 'native' or 'numpy'")


def zbuffer_depth(uvd: np.ndarray, img_h: int, img_w: int,
                  impl: str = "native") -> np.ndarray:
    """[P, 3] (u, v, d) -> [H, W] depth map: the closest positive depth
    of the points that round to each pixel, 0 where none."""
    _check_impl(impl)
    if impl == "native":
        uvd = np.ascontiguousarray(uvd, np.float32)
        out = np.zeros((img_h, img_w), np.float32)
        load().zbuffer_depth(_fptr(uvd), uvd.shape[0], img_h, img_w,
                             _fptr(out))
        return out
    # the C++'s rule: bounds on the unrounded (u, v), then each rounded
    # half up; sorted by descending depth, so that the closest is written
    # last. (JAX's numpy fallback rounds half to even before its bounds
    # test: it departs from its own library at the image's edges.)
    uvd = np.asarray(uvd, np.float32)
    u, v, d = uvd[:, 0], uvd[:, 1], uvd[:, 2]
    valid = (u >= 0) & (v >= 0) & (u <= img_w - 1) & (v <= img_h - 1) \
        & (d > 0)
    half = np.float32(0.5)
    order = np.argsort(-d[valid], kind="stable")
    ui = (u[valid] + half).astype(np.int64)[order]
    vi = (v[valid] + half).astype(np.int64)[order]
    out = np.zeros((img_h, img_w), np.float32)
    out[vi, ui] = d[valid][order]
    return out


def majority_vote(coords: np.ndarray, labels: np.ndarray, grid_size,
                  impl: str = "native") -> np.ndarray:
    """Sparse (coords [n, 3], labels [n]) -> dense [X, Y, Z]: each voxel's
    most frequent label, the smallest on a tie, 0 where none."""
    _check_impl(impl)
    X, Y, Z = [int(g) for g in grid_size]
    if impl == "native":
        coords = np.ascontiguousarray(coords, np.int64)
        labels = np.ascontiguousarray(labels, np.int64)
        grid = np.zeros(X * Y * Z, np.int64)
        load().majority_vote(_iptr(coords), _iptr(labels), coords.shape[0],
                             X, Y, Z, _iptr(grid))
        return grid.reshape(X, Y, Z)
    from ..data.pipelines.load_occupancy import majority_vote_densify
    return majority_vote_densify(coords, labels, (X, Y, Z))


def voxelize_numpy(points: np.ndarray, point_cloud_range, voxel_size,
                   grid_size, max_voxels: int,
                   max_points_per_voxel: int = 10):
    """The reference's sequential hard voxelization, vectorized (numpy):
    voxels in the order of their first point, at most max_voxels, each the
    mean of its first max_points_per_voxel points -> (sorted voxel ids
    [V], mean features [V, F] fp32, summed in fp64)."""
    nx, ny, nz = [int(g) for g in grid_size]
    pts = np.asarray(points, np.float32)
    pcr = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    c = np.floor((pts[:, :3] - pcr[:3]) / vs).astype(np.int64)
    ok = (c >= 0).all(1) & (c[:, 0] < nx) & (c[:, 1] < ny) & (c[:, 2] < nz)
    pts, c = pts[ok], c[ok]
    lid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    ids, first = np.unique(lid, return_index=True)
    kept = ids[np.sort(np.argsort(first, kind="stable")[:max_voxels])]
    order = np.argsort(lid, kind="stable")        # by voxel, then by index
    lid_s = lid[order]
    start = np.searchsorted(lid_s, lid_s)          # each group's first slot
    rank = np.arange(len(lid_s)) - start
    take = (rank < max_points_per_voxel) & np.isin(lid_s, kept)
    slot = np.searchsorted(kept, lid_s[take])
    sums = np.zeros((len(kept), pts.shape[1]), np.float64)
    np.add.at(sums, slot, pts[order][take])
    counts = np.bincount(slot, minlength=len(kept))
    return kept, (sums / counts[:, None]).astype(np.float32)


def voxelize_mean(points: np.ndarray, pc_range, voxel_size, grid_size,
                  max_points: int = 10, max_voxels: int = 90000,
                  impl: str = "native"):
    """Host hard voxelization -> (ids [max_voxels], mean features
    [max_voxels, F], the count of voxels n); rows past n are zeros."""
    _check_impl(impl)
    X, Y, Z = [int(g) for g in grid_size]
    if impl == "native":
        pts = np.ascontiguousarray(points, np.float32)
        pcr = np.ascontiguousarray(pc_range, np.float32)
        vs = np.ascontiguousarray(voxel_size, np.float32)
        ids = np.zeros(max_voxels, np.int64)
        feats = np.zeros((max_voxels, pts.shape[1]), np.float32)
        n = load().voxelize_mean(_fptr(pts), pts.shape[0], pts.shape[1],
                                 _fptr(pcr), _fptr(vs), X, Y, Z, max_points,
                                 max_voxels, _iptr(ids), _fptr(feats))
        return ids, feats, int(n)
    ids, feats = voxelize_numpy(points, pc_range, voxel_size, grid_size,
                                max_voxels, max_points)
    out_ids = np.zeros(max_voxels, np.int64)
    out_feats = np.zeros((max_voxels, points.shape[1]), np.float32)
    out_ids[:len(ids)] = ids
    out_feats[:len(ids), :feats.shape[1]] = feats
    return out_ids, out_feats, len(ids)
