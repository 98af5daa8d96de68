"""Build and load the kernel library (csrc/*.cu): the three model kernels,
the fragment-consensus kernels, the family chain's kernels and pass C's.

nvcc compiles each source in this checkout to an object, all sources at
once in parallel processes, and links them into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds), at
first use, into build/uvc_tpu_torch_kernels/ under the repository root.
The library is loaded with ctypes; each regime's instantiation of each
model kernel is an ``extern "C"`` launcher taking raw pointers, the row
count, the Layout struct and the CUDA stream, and returning the CUDA
error code; the consensus launchers take int32 buffers and sizes, the
family chain's one launcher and pass C's the addresses of their arena's
slots and their parameters.  The build log (``BUILD_INFO["ptxas"]``) holds ptxas's
registers, spills and stack of every kernel.
"""

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "build", "uvc_tpu_torch_kernels")
KERNELS = ("capitals_vq", "dpv", "qual_tail")
REGIMES = ("f64", "f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), "nvcc"):
        if os.path.isabs(cand) and os.path.exists(cand):
            return cand
    return "nvcc"


def load():
    """The loaded kernel library, built from csrc/ on first call.
    ``--fmad=false``: every + - * / rounds on its own, as in the plain
    versions, so only the transcendentals differ from them."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                      + glob.glob(os.path.join(CSRC, "*.cuh")))
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as fh:
                h.update(fh.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"libuvc_kernels_{h.hexdigest()[:16]}.so")
        t0 = time.time()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cus = [s for s in srcs if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cus]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", o, c], text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for c, o in zip(cus, objs)]
            logs = [p.communicate()[0] for p in procs]
            for c, p, log in zip(cus, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {c} "
                                       f"({p.returncode}):\n{log[-4000:]}")
            r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{r.stderr[-4000:]}")
            for o in objs:
                os.remove(o)
            os.replace(tmp, so)
            BUILD_INFO["ptxas"] = "".join(logs)
        BUILD_INFO["seconds"] = time.time() - t0
        BUILD_INFO["path"] = so
        lib = ctypes.CDLL(so)
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for k in KERNELS:
            for reg in REGIMES:
                fn = getattr(lib, f"uvc_{k}_{reg}")
                fn.restype = ci
                fn.argtypes = [vp, vp, vp, vp, ll, vp, vp]
        for fn, args in (
                (lib.uvc_dc_sort_ranges, [vp, ll, ci, vp, vp]),
                (lib.uvc_dc_sort,
                 [vp, ll, ci, ctypes.POINTER(ci), ci, vp, vp]),
                (lib.uvc_dc_segments_unique,
                 [vp, ll, ci, ci, vp, vp, vp, vp, vp]),
                (lib.uvc_dc_segments_groups,
                 [vp, ll, ci, vp, vp, vp, ci, vp])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
        llp = ctypes.POINTER(ll)
        lib.uvc_fc_chain.restype = ci
        lib.uvc_fc_chain.argtypes = [llp, llp, ctypes.c_double, ci, vp]
        lib.uvc_pc_scatter.restype = ci
        lib.uvc_pc_scatter.argtypes = [llp, llp, ci, vp]
        lib.uvc_fc_nslots.restype = ci
        lib.uvc_fc_nparams.restype = ci
        lib.uvc_error_string.restype = ctypes.c_char_p
        lib.uvc_error_string.argtypes = [ctypes.c_int]
        lib.uvc_dc_sort_scratch.restype = ll
        lib.uvc_dc_sort_scratch.argtypes = [ll, ci]
        lib.uvc_dc_segments_scratch.restype = ll
        lib.uvc_dc_segments_scratch.argtypes = [ll]
        lib.uvc_layout_size.restype = ctypes.c_longlong
        lib.uvc_layout_size.argtypes = []
        _LIB = lib
        return lib
