"""Native (C++) hot-path kernels for the cluster simulator: the lookahead
tick engine (``cluster._run_lookahead``) and the first-fit block search,
in C++ with flat array interfaces, loaded via ctypes.

Port: a copy of ``ddls_tpu/native/__init__.py`` and ``engine.cpp``. The
library is compiled with g++ at first use into ``_build/`` beside this
file. Unlike the JAX package, which falls back to other engines when the
toolchain is missing, a build or load that fails RAISES here: the port has
no JAX lookahead to fall back to.

Contract: kernels are bit-exact with the host engines (f64, identical
operation order).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "libddls_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _compile() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return
    # per-pid temp + atomic replace: concurrent first use across processes
    # must not interleave output
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native engine failed ({' '.join(cmd)}):\n"
                f"{proc.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ddls_lookahead.restype = None
    lib.ddls_lookahead.argtypes = [
        ctypes.c_int64, _f64, _i32, _f64, _i32,        # ops
        ctypes.c_int64, _f64, _i32, _i32, _u8, _u8, _f64,  # deps
        ctypes.c_int64, _i32,                          # links, dep_channel
        ctypes.c_int64, ctypes.c_int64,                # workers, channels
        _f64,                                          # out[5]
    ]
    lib.ddls_first_fit_block.restype = ctypes.c_int64
    lib.ddls_first_fit_block.argtypes = [
        _i64, ctypes.c_int64,                          # shapes [n,3]
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # meta shape
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # ramp shape
        _f64, _u8,                                     # mem, blocked
        ctypes.c_double, ctypes.c_int32,               # op_size, check_mem
        ctypes.c_int32,                                # meta_scan
        _i64, _i32,                                    # out_origin, out
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The compiled kernel library, built at first use; raises when g++
    or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _compile()
            _lib = _bind(ctypes.CDLL(_LIB))
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded (a failure raises)."""
    return get_lib() is not None


def run_first_fit_block(shapes, meta_shape, ramp_shape, mem, blocked,
                        op_size, meta_scan: bool):
    """First-fit block search on the C++ kernel.

    ``shapes``: [n, 3] int64 candidate shapes (search order preserved;
    -1 in the last slot selects the diagonal layout). ``mem``/``blocked``:
    C-order [C*R*S] views of the ramp snapshot. Returns
    (list of (c, r, s) coords in enumeration order, origin) or None when
    nothing fits."""
    lib = get_lib()
    shapes = np.ascontiguousarray(shapes, np.int64)
    if shapes.size == 0:
        return None
    rC, rR, rS = ramp_shape
    if meta_scan and (meta_shape[0] > rC or meta_shape[1] > rR
                      or meta_shape[2] > rS):
        # a meta block larger than the ramp can never fit (find_meta_block's
        # span guard); bailing here also keeps the out buffer bound valid
        return None
    # worst-case servers a candidate block can cover: the kernel writes
    # C*R*S cells per attempt (diagonal shapes cover |C| cells; abs also
    # turns the -1 marker into a safe overestimate)
    max_block = int(np.abs(shapes).prod(axis=1).max())
    out = np.empty((max(rC * rR * rS, max_block), 3), np.int32)
    origin = np.zeros(3, np.int64)
    n = lib.ddls_first_fit_block(
        shapes, shapes.shape[0], meta_shape[0], meta_shape[1],
        meta_shape[2], rC, rR, rS,
        np.ascontiguousarray(mem, np.float64),
        np.ascontiguousarray(blocked, np.uint8),
        float(op_size) if op_size is not None else 0.0,
        1 if op_size is not None else 0,
        1 if meta_scan else 0, origin, out)
    if n == 0:
        return None
    block = [tuple(int(x) for x in row) for row in out[:n]]
    return block, (int(origin[0]), int(origin[1]), int(origin[2]))


def run_lookahead(arrays) -> Optional[Tuple[float, float, float, float]]:
    """Run the C++ lookahead on a ``LookaheadArrays`` built with
    ``dtype=np.float64`` and exact (unpadded) sizes. Returns
    (t, comm_overhead, comp_overhead, busy) for ONE training step, or
    None when the engine could not finish (caller falls back to the host
    engine, which raises with diagnostics)."""
    lib = get_lib()
    a = arrays
    out = np.zeros(5, dtype=np.float64)
    lib.ddls_lookahead(
        a.op_remaining.shape[0],
        np.ascontiguousarray(a.op_remaining, np.float64),
        np.ascontiguousarray(a.op_worker, np.int32),
        np.ascontiguousarray(a.op_score, np.float64),
        np.ascontiguousarray(a.num_parents, np.int32),
        a.dep_remaining.shape[0],
        np.ascontiguousarray(a.dep_remaining, np.float64),
        np.ascontiguousarray(a.dep_src, np.int32),
        np.ascontiguousarray(a.dep_dst, np.int32),
        np.ascontiguousarray(a.dep_mutual, np.uint8),
        np.ascontiguousarray(a.dep_is_flow, np.uint8),
        np.ascontiguousarray(a.dep_score, np.float64),
        a.dep_channel.shape[1],
        np.ascontiguousarray(a.dep_channel, np.int32),
        a.num_workers, a.num_channels, out)
    if out[4] != 1.0:
        return None
    return float(out[0]), float(out[1]), float(out[2]), float(out[3])
