"""ctypes binding of the native BVH builder (`csrc/bvh_builder.cpp`; port
of pbrlab_tpu.geometry.native).

The library is compiled at first use with the host C++ compiler, with the
JAX package's flags (`c++ -O3 -march=native -shared -fPIC`), into
`build/`; its name carries a hash of the source, the flags and the ISA
macros the compiler enables for this host's CPU, so neither a stale build
nor one made on another CPU is loaded. A failed compile raises: the
numpy build gives a different tree, so falling back would silently change
every slot id of a large scene.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

CXX = "c++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bvh_builder.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LOCK = threading.Lock()
_LIB = None


def _host_isa() -> bytes:
    """The predefined macros of `CXX -march=native` on this host (__AVX2__,
    __AVX512F__, ...): what the library may execute."""
    proc = subprocess.run([CXX, "-march=native", "-dM", "-E", "-x", "c++",
                           "-"], input="", capture_output=True, text=True,
                          timeout=60)
    return proc.stdout.encode()


def build_library() -> Path:
    """Compile csrc/bvh_builder.cpp into build/ (once per source, flag set
    and host ISA) and return the library's path."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _host_isa()).hexdigest()[:16]
    out = _BUILD_DIR / f"libbvh_builder_{tag}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([CXX, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"c++ failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.pbrlab_bvh_build.argtypes = [fp, fp, ctypes.c_int64,
                                             ctypes.c_int32,
                                             ctypes.POINTER(ctypes.c_int64)]
            lib.pbrlab_bvh_build.restype = ctypes.c_int64
            lib.pbrlab_bvh_read.argtypes = [fp, fp, ip, ip, ip]
            lib.pbrlab_bvh_read.restype = None
            lib.pbrlab_bvh_free.argtypes = []
            lib.pbrlab_bvh_free.restype = None
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_bvh_native(prim_bmin: np.ndarray, prim_bmax: np.ndarray,
                     leaf_size: int):
    """Native threaded-BVH build -> geometry.bvh.BVH (the numpy build's
    layout contract)."""
    from .bvh import BVH

    lib = _lib()
    bmin = np.ascontiguousarray(prim_bmin, np.float32)
    bmax = np.ascontiguousarray(prim_bmax, np.float32)
    n_slots = ctypes.c_int64(0)
    f, i = ctypes.c_float, ctypes.c_int32
    with _LOCK:  # the library keeps one build at a time
        n_nodes = lib.pbrlab_bvh_build(_ptr(bmin, f), _ptr(bmax, f),
                                       bmin.shape[0], leaf_size,
                                       ctypes.byref(n_slots))
        node_bmin = np.empty((n_nodes, 3), np.float32)
        node_bmax = np.empty((n_nodes, 3), np.float32)
        skip = np.empty((n_nodes,), np.int32)
        prim_offset = np.empty((n_nodes,), np.int32)
        prim_ids = np.empty((n_slots.value,), np.int32)
        lib.pbrlab_bvh_read(_ptr(node_bmin, f), _ptr(node_bmax, f),
                            _ptr(skip, i), _ptr(prim_offset, i),
                            _ptr(prim_ids, i))
        lib.pbrlab_bvh_free()
    return BVH(aabb_min=node_bmin, aabb_max=node_bmax, skip=skip,
               prim_offset=prim_offset, prim_ids=prim_ids)
