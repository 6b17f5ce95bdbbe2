"""Build and load the port's CUDA kernels.

The sources under crossscalepatchmatch_tpu_torch/csrc/ are compiled at
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/libcspm_kernels_<hash>.so

into a shared library with a plain C interface, loaded with ctypes.  The
file name carries a hash of the sources, so an edited source is rebuilt and
a built library is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("window_cost.cu", "quadrant_build.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every entry returns cudaError_t)
SIGNATURES = {
    # img, vol, vol_bf16, max_costs, abc, lut, out,
    # K, H, W, D, half_wnd, max_dis, stream
    "cspm_window_cost": (_P, _P, _I, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _P),
    # img, vol, vol_bf16, lut, bq, wq, H, W, D, half_wnd, stride, stream
    "cspm_quadrant_build": (_P, _P, _I, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P),
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcspm_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the current sources have no library yet.

    Returns the library path; raises RuntimeError with nvcc's output on a
    failed build.
    """
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temporary name and rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           *[os.path.join(SRC_DIR, s) for s in SOURCES]]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc could not be started ({cmd[0]}): {e}")
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    if verbose:
        print(f"nvcc: {time.perf_counter() - t0:.2f} s")
        print(res.stderr, end="")
    os.replace(tmp, path)
    return path


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
