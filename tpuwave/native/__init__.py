"""ctypes bindings to the native runtime (native/tpuwave_native.cpp).

The shared library is built on demand with the system toolchain; every
entry point has a pure-Python fallback, so the framework works without a
compiler — the native path just makes host-side IO and mesh setup fast at
production scales (a 4096^2 P2 connectivity build or per-step binary VTU
write is milliseconds in C++ vs seconds in Python).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["get_lib", "available", "p1_cells", "p2_cell_dofs",
           "write_vtu_native", "write_mesh_vtk_native"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libwave_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    src = _NATIVE_DIR / "tpuwave_native.cpp"
    if not src.exists():
        return False
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TPUWAVE_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    i32, i64 = ctypes.c_int32, ctypes.c_int64
    pd = ctypes.POINTER(ctypes.c_double)
    pi = ctypes.POINTER(ctypes.c_int32)
    pc = ctypes.c_char_p

    lib.tw_p1_cells.argtypes = [i32, i32, pi]
    lib.tw_p2_cell_dofs.argtypes = [i32, i32, pi]
    lib.tw_write_vtu.restype = i32
    lib.tw_write_vtu.argtypes = [
        pc, pd, i64, pi, i64,
        ctypes.POINTER(pc), ctypes.POINTER(pd), i32,
        ctypes.POINTER(pc), ctypes.POINTER(pd), i32,
    ]
    lib.tw_write_mesh_vtk.restype = i32
    lib.tw_write_mesh_vtk.argtypes = [pc, pd, i64, pi, i64]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _as_c(arr, dtype):
    out = np.ascontiguousarray(arr, dtype=dtype)
    return out, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double) if dtype == np.float64
        else ctypes.POINTER(ctypes.c_int32))


def p1_cells(nx: int, ny: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((2 * nx * ny, 3), dtype=np.int32)
    lib.tw_p1_cells(nx, ny, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def p2_cell_dofs(nx: int, ny: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((2 * nx * ny, 6), dtype=np.int32)
    lib.tw_p2_cell_dofs(nx, ny,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def write_vtu_native(path, points3: np.ndarray, cells: np.ndarray,
                     point_data: Dict[str, np.ndarray],
                     cell_data: Dict[str, np.ndarray]) -> bool:
    """Raw-appended-binary VTU write; returns False if native unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    pts, pts_p = _as_c(points3, np.float64)
    cls, cls_p = _as_c(cells, np.int32)

    def field_block(data: Dict[str, np.ndarray], n_expected: int):
        names, ptrs, keep = [], [], []
        for name, arr in data.items():
            a = np.ascontiguousarray(arr, dtype=np.float64)
            assert a.shape == (n_expected,), (name, a.shape)
            keep.append(a)
            names.append(name.encode())
            ptrs.append(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        n = len(names)
        name_arr = (ctypes.c_char_p * max(n, 1))(*names)
        ptr_arr = (ctypes.POINTER(ctypes.c_double) * max(n, 1))(*ptrs)
        return name_arr, ptr_arr, n, keep

    pd_names, pd_ptrs, n_pd, keep1 = field_block(point_data, points3.shape[0])
    cd_names, cd_ptrs, n_cd, keep2 = field_block(cell_data, cells.shape[0])
    rc = lib.tw_write_vtu(str(path).encode(), pts_p, points3.shape[0],
                          cls_p, cells.shape[0],
                          pd_names, pd_ptrs, n_pd, cd_names, cd_ptrs, n_cd)
    return rc == 0


def write_mesh_vtk_native(path, pts_xy: np.ndarray, cells: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    pts, pts_p = _as_c(pts_xy, np.float64)
    cls, cls_p = _as_c(cells, np.int32)
    rc = lib.tw_write_mesh_vtk(str(path).encode(), pts_p, pts_xy.shape[0],
                               cls_p, cells.shape[0])
    return rc == 0
