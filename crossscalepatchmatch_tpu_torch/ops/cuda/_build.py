"""Build and load the port's CUDA kernels.

Each source under crossscalepatchmatch_tpu_torch/csrc/ is compiled at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<name>_<hash>.so

into a shared library with a plain C interface, loaded with ctypes.  The
nvcc processes of all sources that have no library yet run at the same
time.  A file name carries a hash of its source and of the headers
(csrc/*.cuh), so an edited source is rebuilt and a built library is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint
# source -> its C entry points: name -> argument types (every entry returns
# cudaError_t)
SOURCES = {
    "quadrant_build.cu": {
        # img, vol (pair layout), vol_bf16, lut, bq, wq, H, W, D, band
        # (host int[8]: Ho, Wo, oy, ox, ylo, yhi, xlo, xhi), half_wnd,
        # stride, stream
        "cspm_quadrant_build": (_P, _P, _I, _P, _P, _P,
                                _I, _I, _I, _P, _I, _I, _P),
    },
    "cross_scale_cost.cu": {
        # per-level host arrays: imgs, vols, max_costs, geom (int[10] a
        # level: Hs, Ws, Ds, max_dis, oy, ox, ylo, yhi, xlo, xhi), wgts;
        # levels, vol_bf16, abc, lut, out, K, H, W, half_wnd, stride, stream
        "cspm_cross_scale_cost": (_P, _P, _P, _P, _P,
                                  _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P),
    },
    "fly_cost.cu": {
        # per-level host arrays: refs (colour, gradient), wgt imgs, hs, ws,
        # max_dis, scale wgts; levels, image, lab, coef[6] (host), abc,
        # lut, out, K, H, W, half_wnd, stride, the launch plan (rows,
        # tile_rows, lattice, cands, per_chunk, smem), stream
        "cspm_fly_cost": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                          _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _P),
    },
    "weighted_median.cu": {
        # dis, imgs, valid, packed, counts, len(counts), idx, n (device),
        # out, H, W, Ho, Wo, oy, ox, stream
        "cspm_wmf_prepare": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P),
        # packed, lut, idx, n (device), out, H, W, Ho, Wo, oy, ox,
        # half_wnd, stream
        "cspm_weighted_median": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P),
    },
    "grd_volume.cu": {
        # l, its strides (y, x, c), r, its strides, out, H, W, D, alpha,
        # 1 - alpha, tau_clr, tau_grd, border_thres, stream
        "cspm_grd_volume": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _I, _I, _I,
                            _F, _F, _F, _F, _F, _P),
    },
    "census_volume.cu": {
        # l, its strides (y, x, c), r, its strides, codes, out, H, W, D,
        # wnd, stream
        "cspm_census_volume": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _I,
                               _I, _I, _I, _P),
    },
    "quadrant_rank.cu": {
        # bq, wq, max_costs, abc, out, K, H, W, D, max_dis, half_wnd, stream
        "cspm_quadrant_rank": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P),
    },
    "refine_propose.cu": {
        # abc, out, K, H, W, i0, iteration, phase, k0, k1, eps, mags (host
        # float[4][K]), stream
        "cspm_refine_propose": (_P, _P, _I, _I, _I, _I, _U, _U, _U, _U, _F,
                                _P, _P),
    },
    "bilateral_volume.cu": {
        # vol, guide, out, V, H, W, D, wnd, inv_sp2, inv_clr2, the launch
        # plan (dc, per_chunk, chunks, wx, wy), stream
        "cspm_bilateral_volume": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                  _I, _I, _I, _I, _I, _P),
    },
    "f32_peak.cu": {
        # x, out, n, iters, m, c, stream
        "cspm_f32_peak": (_P, _P, ctypes.c_long, _I, ctypes.c_float,
                          ctypes.c_float, _P),
    },
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def library_path(source: str) -> str:
    h = hashlib.sha256()
    # the source and every header beside it (a source may include any)
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> list:
    """Compile every source that has no library yet, all at once.

    Returns the library paths; raises RuntimeError with nvcc's output on a
    failed build.
    """
    paths = [library_path(src) for src in SOURCES]
    todo = [(src, path) for src, path in zip(SOURCES, paths)
            if not os.path.exists(path)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    try:
        for src, path in todo:
            # build to a temporary name and rename: concurrent builders
            # never see a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                   os.path.join(SRC_DIR, src)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
            except OSError as e:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc could not be started ({cmd[0]}): {e}")
            jobs.append((src, path, tmp, cmd, proc))
        failed = []
        for src, path, tmp, cmd, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}\n{err}")
                continue
            if verbose:
                print(f"nvcc {src}:")
                print(err, end="")
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if verbose:
        print(f"nvcc: {len(todo)} sources in parallel, "
              f"{time.perf_counter() - t0:.2f} s")
    return paths


def load():
    """The kernels' C entry points, as attributes of one namespace (the
    libraries are built first if needed)."""
    global _lib
    if _lib is None:
        # the loaded libraries ride along, so they live as long as their
        # entry points
        fns = {"libraries": []}
        for sigs, path in zip(SOURCES.values(), build()):
            lib = ctypes.CDLL(path)
            fns["libraries"].append(lib)
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
