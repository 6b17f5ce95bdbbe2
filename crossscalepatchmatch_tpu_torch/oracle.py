"""ctypes binding to the native CPU oracle, csrc/cspm_oracle.cc at the
repository's root (the port's own copy of crossscalepatchmatch_tpu.oracle;
no jax).

The library is built on first use with g++ -O3 -fopenmp into
build/oracle/, named by a hash of the source and the flags, so an edited
source is rebuilt; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_ROOT, "csrc", "cspm_oracle.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "oracle")
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
         "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcspm_oracle_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the oracle unless this source's library exists; returns its
    path.  Raises RuntimeError with the compiler's output on a failure."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        res = subprocess.run(["g++", *FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the oracle failed "
                               f"(g++ exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cspm_oracle_run.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, u8p]
        lib.cspm_oracle_run.restype = ctypes.c_int
        _lib = lib
    return _lib


def run_pair(left_bgr: np.ndarray, right_bgr: np.ndarray, *, max_dis: int,
             dis_scale: int, cc_name: str = "GRD", use_cs: bool = False,
             use_pp: bool = False, reg_lambda: float = 0.0,
             max_iter: int = 3, wnd_size: int = 35, scale_num: int = 5,
             seed: int = 0) -> np.ndarray:
    """Run the sequential CPU pipeline; returns u8[2, H, W] disparity maps."""
    lib = _load()
    l = np.ascontiguousarray(left_bgr, np.uint8)
    r = np.ascontiguousarray(right_bgr, np.uint8)
    if l.ndim != 3 or l.shape[2] != 3 or l.shape != r.shape:
        raise ValueError(f"views {l.shape} and {r.shape} are not two "
                         "u8[H, W, 3] of one shape")
    h, w, _ = l.shape
    out = np.zeros((2, h, w), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.cspm_oracle_run(
        l.ctypes.data_as(u8p), r.ctypes.data_as(u8p), h, w, max_dis,
        dis_scale, 1 if cc_name.upper() == "GRD" else 0, int(use_cs),
        int(use_pp), reg_lambda, max_iter, wnd_size, scale_num, seed,
        out.ctypes.data_as(u8p))
    if rc != 0:
        raise RuntimeError(f"oracle returned {rc}")
    return out
