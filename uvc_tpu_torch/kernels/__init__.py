"""The packed quality model's three hand-written CUDA kernels (csrc/), their
wrappers and their plain PyTorch versions.

Each wrapper takes the packed request ``pi`` and the outputs ``oi``/``of``
(allocated by the caller with torch.empty) plus the QualityModel that
holds the layout, cfg vector and tables; K2 and K3 also take the request's
mode: ``is_tumor_only`` and, in the rescued mode, the float wire ``pf``.
On a CPU tensor a wrapper runs the kernel's plain version; on a CUDA
tensor it launches the kernel on the current stream, or raises.
``LAUNCHES`` counts kernel launches, one per launch, per kernel; a
launch in the rescued mode also counts under ``<kernel>_rescued``.  The
fragment-consensus kernels (ops/device_consensus.py) and the family
chain's (family/device_chain.py: frag_merge, fam_merge, sweep2 and their
chain_scan) and pass C's (pileup/device_pass_c.py: pass_c, its two
kernels) count theirs here too.
"""

import ctypes
import threading

import torch

LAUNCHES = {"capitals_vq": 0, "dpv": 0, "qual_tail": 0, "dpv_rescued": 0,
            "qual_tail_rescued": 0, "dc_sort": 0, "dc_segments": 0,
            "frag_merge": 0, "fam_merge": 0, "sweep2": 0, "chain_scan": 0,
            "pass_c": 0}
_COUNT_LOCK = threading.Lock()


def reset_launches():
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name, n=1):
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def launch(name, pi, oi, of, model, pf=None, is_tumor_only=True):
    """Launch kernel ``name`` over every row of ``pi`` in the request's
    mode (``pf`` given: rescued); raise on anything the kernel does not
    take or on a CUDA error."""
    from . import build
    from .layout import PF_COLS, Layout, with_mode
    R = pi.shape[0]
    reg = model.regime
    checks = [(pi, "pi", reg.itype, model.layout.ci),
              (oi, "oi", reg.itype, model.layout.coi),
              (of, "of", reg.ftype, model.layout.cof)]
    if pf is not None:
        checks.append((pf, "pf", reg.ftype, PF_COLS))
    for t, nm, dt, cols in checks:
        if not t.is_cuda:
            raise ValueError(f"{name}: {nm} is not a CUDA tensor")
        if t.device != pi.device:
            raise ValueError(f"{name}: {nm} on {t.device}, pi on {pi.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {nm} is {t.dtype}, the {reg.name} "
                            f"regime needs {dt}")
        if t.dim() != 2 or t.shape[0] != R or t.shape[1] != cols:
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, "
                             f"expected ({R}, {cols})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if R == 0:
        return
    lib = build.load()
    if lib.uvc_layout_size() != ctypes.sizeof(Layout):
        raise RuntimeError("csrc Layout struct and kernels/layout.py differ")
    L = with_mode(model.layout_struct, is_tumor_only, pf is not None)
    stream = torch.cuda.current_stream(pi.device).cuda_stream
    fn = getattr(lib, f"uvc_{name}_{reg.name}")
    with torch.cuda.device(pi.device):
        rc = fn(pi.data_ptr(), None if pf is None else pf.data_ptr(),
                oi.data_ptr(), of.data_ptr(), R, ctypes.addressof(L), stream)
    check(lib, name, rc)
    count(name)
    if pf is not None and f"{name}_rescued" in LAUNCHES:
        count(f"{name}_rescued")


def check(lib, name, rc):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.uvc_error_string(rc).decode()})")
