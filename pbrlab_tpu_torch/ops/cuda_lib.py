"""The port's one CUDA library: every `csrc/*.cu` built with nvcc for
sm_90a into `build/`, loaded with ctypes.

Each source compiles to an object file in its own nvcc process, all
started together, and the objects link into one shared library whose name
carries a hash of every source, every header (`*.cuh`) and the flags, so
a stale build is never loaded. The kernels expose a plain C interface
(device pointers, ints and the CUDA stream); the wrappers in
`ops/dense*.py` declare their argument types through `function`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import profiling

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false keeps every product and sum separately rounded, as the plain
# torch versions compute them, so kernels and plain versions agree to the
# bit; no --use_fast_math: the divisions stay IEEE.
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v"]
_lib = None


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def build_library():
    """Compile and link csrc/*.cu once per source and flag set. Returns
    (library path, nvcc log with each kernel's -Xptxas -v report)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # the sources and headers
        digest.update(src.name.encode() + src.read_bytes())
    out = _BUILD_DIR / f"libpbrlab_cuda_{digest.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if not out.exists():
        with profiling.span("cuda_lib.build", library=out.name):
            _compile(out, log)
    return out, log.read_text() if log.exists() else ""


def _compile(out: Path, log: Path):
    """nvcc every source into an object, all at once, and link `out`."""
    work = _BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{s.stem}.o" for s in sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o",
                               str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources(), objs)]
    text = []
    for src, proc in zip(sources(), procs):
        stdout, _ = proc.communicate()
        text.append(f"== {src.name}\n{stdout}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{stdout}")
    proc = subprocess.run([_nvcc(), *ARCH, "-shared", "-o",
                           str(work / out.name), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
    log.write_text("\n".join(text))
    os.replace(work / out.name, out)
    shutil.rmtree(work)


def function(name: str, argtypes):
    """The C function `name` of the library (built at first use), with
    its argument types set and an int (cudaError_t) result."""
    global _lib
    if _lib is None:
        path = build_library()[0]
        with profiling.span("cuda_lib.load", library=path.name):
            _lib = ctypes.CDLL(str(path))
    fn = getattr(_lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launched(name: str, rc: int):
    """Raise if a kernel launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def check_tensor(kernel: str, x, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device`, as the kernel reads it."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{kernel} kernel wants a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def check_float4_rows(kernel: str, table, stride: int):
    """Raise unless the kernel can read `table`'s leaf rows as float4:
    16-byte aligned, rows `stride` floats apart, stride a multiple of 4.
    The leaves' slot bases (multiples of 32) are checked where the tables
    are built (`scene.instanced.build_instanced`)."""
    if table.data_ptr() % 16 or stride % 4:
        raise ValueError(f"{kernel} kernel reads its table as float4: it "
                         "must be 16-byte aligned with a row stride that is "
                         f"a multiple of 4 floats; got address "
                         f"{table.data_ptr():#x}, stride {stride}")
