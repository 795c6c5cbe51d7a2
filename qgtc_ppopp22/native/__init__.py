"""ctypes bindings for the native host library (``qgtc_native.cpp``).

Fills the native-code roles the reference delegates to DGL's C++ core
and its CUDA host layer (SURVEY §2: METIS partitioning, subgraph
extraction, host-side packing). The library is built lazily with g++
on first import (cached as ``libqgtc_native.so`` next to the source);
every entry point has a NumPy fallback elsewhere in the package, so
the framework works without a toolchain — just slower on the host
pipeline.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libqgtc_native.so")
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    src = os.path.join(_DIR, "qgtc_native.cpp")
    cmd = [
        "g++", "-O3", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", src, "-o", _SO,
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=300
        )
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"native build failed: {detail[:500]}")


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_DIR, "qgtc_native.cpp")
    if not os.path.exists(_SO) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_SO)
    ):
        _build()
    lib = ctypes.CDLL(_SO)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.csr_from_edges.restype = ctypes.c_int64
    lib.csr_from_edges.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
    ]
    lib.partition_graph.restype = ctypes.c_int32
    lib.partition_graph.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i32p,
    ]
    lib.subgraph_dense.restype = None
    lib.subgraph_dense.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.quantize_f32.restype = None
    lib.quantize_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, i32p]
    lib.pack_bits_u32.restype = None
    lib.pack_bits_u32.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, u32p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def partition_native(g, psize: int, seed: int = 0) -> List[np.ndarray]:
    """Multilevel partition (coarsen + grow + refine); returns node-id
    lists like :func:`qgtc_ppopp22.graph.partition.get_partition_list`."""
    lib = get_lib()
    adj = g.undirected_scipy()
    indptr = np.ascontiguousarray(adj.indptr, np.int64)
    indices = np.ascontiguousarray(adj.indices, np.int64)
    labels = np.empty(g.num_nodes, np.int32)
    rc = lib.partition_graph(
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64),
        ctypes.c_int64(g.num_nodes),
        ctypes.c_int64(psize),
        ctypes.c_uint64(seed),
        _ptr(labels, ctypes.c_int32),
    )
    if rc != 0:
        raise NativeUnavailable(f"partition_graph rc={rc}")
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    bounds = np.searchsorted(sorted_labels, np.arange(psize + 1))
    return [
        np.sort(order[bounds[i]: bounds[i + 1]]).astype(np.int64)
        for i in range(psize)
    ]


def subgraph_dense_native(
    indptr: np.ndarray,
    indices: np.ndarray,
    nodes: np.ndarray,
    padded: int,
) -> np.ndarray:
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    nodes = np.ascontiguousarray(nodes, np.int64)
    dense = np.zeros((padded, padded), np.uint8)
    lib.subgraph_dense(
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64),
        _ptr(nodes, ctypes.c_int64),
        ctypes.c_int64(len(nodes)),
        ctypes.c_int64(padded),
        _ptr(dense, ctypes.c_uint8),
    )
    return dense


def quantize_native(x: np.ndarray, bits: int) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    q = np.empty(x.shape, np.int32)
    lib.quantize_f32(
        _ptr(x, ctypes.c_float),
        ctypes.c_int64(x.size),
        ctypes.c_int32(bits),
        _ptr(q, ctypes.c_int32),
    )
    return q


def pack_bits_native(q: np.ndarray, bits: int, Mp: int, Kp: int) -> np.ndarray:
    """int32 levels (M, K) -> zeroed+packed uint32 [bits, Mp/32, Kp]."""
    lib = get_lib()
    q = np.ascontiguousarray(q, np.int32)
    M, K = q.shape
    planes = np.zeros((bits, Mp // 32, Kp), np.uint32)
    lib.pack_bits_u32(
        _ptr(q, ctypes.c_int32),
        ctypes.c_int64(M),
        ctypes.c_int64(K),
        ctypes.c_int32(bits),
        ctypes.c_int64(Mp),
        ctypes.c_int64(Kp),
        _ptr(planes, ctypes.c_uint32),
    )
    return planes


def pack_bits_u32_2d(
    q: np.ndarray, bits: int, Mp: int, Kp: int
) -> np.ndarray:
    """Like :func:`pack_bits_native` but accepts any integer dtype."""
    return pack_bits_native(np.asarray(q, np.int32), bits, Mp, Kp)


def csr_from_edges_native(
    src: np.ndarray, dst: np.ndarray, n: int
) -> tuple:
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(len(src), np.int64)
    nnz = lib.csr_from_edges(
        _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64),
        ctypes.c_int64(len(src)),
        ctypes.c_int64(n),
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64),
    )
    return indptr, indices[:nnz].copy()
