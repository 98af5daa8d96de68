"""The fragment consensus reduction on the device (B1): the counterpart of
uvc_tpu/ops/device_consensus.py, behind UVC_TPU_DEVICE_PREPARE=1
(pileup/region.py).

``device_reduce_consensus`` takes flat (group, pos, symbol, value) event
columns and returns, row for row as the JAX package's host wrapper does,
the unique (group, pos, symbol) rows with the max or sum of their values
and the per-(group, pos, symbol type) consensus rows:

  - BASE consensus: the first maximum over symbols 0..5, tot = the sum;
  - LINK with link_m_overridden: non-LINK_M symbols override LINK_M,
    tot = the winner's count only;
  - plain LINK: the first maximum over 6..13 with the full sum.

The work runs on int32 tables of a power-of-two bucket of rows (the JAX
program's shapes) through two kernel families of csrc/device_consensus.cu:
``dc_sort`` (a stable lexicographic sort of the table's rows, an LSD radix
sort over the key columns packed into 64-bit words by ``sort_plan``) and
``dc_segments`` (the segment reduce of the sorted unique rows, stage 1, and
the consensus of the sorted groups, stage 2).  One call launches each
family twice: sort, segments, sort, segments.  On a CPU tensor each
wrapper runs its plain PyTorch version (stable ``torch.sort`` passes from
the last key to the first; ``scatter_reduce`` for the segment max, sum and
min), on a CUDA tensor its kernel, or raises.

``DEVICE`` says where the tables go: the card unless a caller sets it to
the CPU, as the CLI does from ``--device``; without a card the program
raises.  The CLI's worker threads call in concurrently; a lock
serializes the device work.
"""

import ctypes
import threading

import numpy as np
import torch

from ..constants import Symbol
from .. import kernels

# calls and event rows through device_reduce_consensus (the CLI's summary)
STATS = {"calls": 0, "rows": 0}

# where device_reduce_consensus runs; set by the CLI from --device
DEVICE = torch.device("cuda")

_LOCK = threading.Lock()

# the tables' columns: the stage-1 sort input and the stage-2 sort input
# (built by dc_segments stage 1); the sorts are stable on the JAX
# program's keys (num_keys 4 and 7), and idx, each row's position before
# the sort, rides along
COLS1 = ("inval", "g", "p", "s", "idx", "v")
COLS2 = ("c_inv", "g", "p", "st", "cls", "negv", "s", "idx", "v")
NKEYS1, NKEYS2 = 4, 7


def _bucket(n):
    b = 1024
    while b < n:
        b *= 2
    return b


def _check_table(name, buf, ncols):
    if (buf.dtype != torch.int32 or buf.dim() != 2
            or buf.shape[0] not in ncols):
        raise ValueError(f"{name}: want an int32 table of {ncols} columns "
                         f"by N rows, got {buf.dtype} {tuple(buf.shape)}")
    N = buf.shape[1]
    if N < 1024 or N & (N - 1):
        raise ValueError(f"{name}: N = {N} is not a power of two >= 1024")
    if not buf.is_contiguous():
        raise ValueError(f"{name}: table is not contiguous")
    return N


# ---- dc_sort ----------------------------------------------------------------

def dc_sort_plain(buf, nkeys):
    """Sort the rows (columns of ``buf``) ascending by key rows 0..nkeys-1,
    lexicographically: stable sorts from the last key to the first."""
    perm = torch.arange(buf.shape[1], device=buf.device)
    for k in range(nkeys - 1, -1, -1):
        perm = perm[torch.sort(buf[k, perm], stable=True).indices]
    buf.copy_(buf[:, perm])


class SortPlan:
    """The radix sort's plan: ``widths`` (bits of each key), ``words``
    (least significant first, each a list of (key, shift, min)), ``bits``
    and ``digits`` (8-bit digit passes) of each word, and ``ints``, the
    array the kernels and the host build take."""

    def __init__(self, widths, words):
        self.widths, self.words = widths, words
        self.bits = [sh + widths[k] for k, sh, _ in (w[-1] for w in words)]
        self.digits = [-(-b // 8) for b in self.bits]
        self.ints = [len(words)]
        for w, nd in zip(words, self.digits):
            self.ints += [len(w), nd]
            for key in w:
                self.ints += list(key)

    def __str__(self):
        return (f"key widths {self.widths}: {len(self.words)} word(s) of "
                f"{self.bits} bits, {sum(self.digits)} digit passes")


def sort_plan(lo, hi):
    """The plan for key columns with minima ``lo`` and maxima ``hi`` (key
    0 first): key k takes bitlen(hi - lo) bits (in Python ints, so any
    int32 range works); from the last key to the first, keys fill 64-bit
    words without being split; a key of width 0 takes no bits."""
    widths = [int(h - l).bit_length() for l, h in zip(lo, hi)]
    words, cur, bits = [], [], 0
    for k in range(len(widths) - 1, -1, -1):
        if widths[k] == 0:
            continue
        if bits + widths[k] > 64:
            words.append(cur)
            cur, bits = [], 0
        cur.append((k, bits, int(lo[k])))
        bits += widths[k]
    if cur:
        words.append(cur)
    return SortPlan(widths, words)


def decode_ranges(rng):
    """(minima, maxima) of the key columns from the ranges kernel's
    2 * nkeys uint32s (as int32 or uint32 numbers): the min of each key's
    order-preserving unsigned image, then the min of its complement."""
    u = np.asarray(rng, dtype=np.int64) & 0xFFFFFFFF
    return ([int(x) - 2**31 for x in u[0::2]],
            [0xFFFFFFFF - int(x) - 2**31 for x in u[1::2]])


def dc_sort(buf, nkeys):
    """Sort the int32 table ``buf`` [A, N] in place by its first ``nkeys``
    rows, stably: the kernel on a CUDA tensor (returns its SortPlan), the
    plain version on a CPU one."""
    N = _check_table("dc_sort", buf, range(1, len(COLS2) + 1))
    A = buf.shape[0]
    if not 0 < nkeys <= A:
        raise ValueError(f"dc_sort: {nkeys} keys of a {A}-column table")
    if buf.device.type == "cpu":
        return dc_sort_plain(buf, nkeys)
    from ..kernels import build
    lib = build.load()
    dev = buf.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rng = torch.empty(2 * nkeys, dtype=torch.int32, device=dev)
        kernels.check(lib, "dc_sort", lib.uvc_dc_sort_ranges(
            buf.data_ptr(), N, nkeys, rng.data_ptr(), stream))
        plan = sort_plan(*decode_ranges(rng.cpu().numpy()))
        scratch = torch.empty(lib.uvc_dc_sort_scratch(N, A),
                              dtype=torch.uint8, device=dev)
        ints = (ctypes.c_int * len(plan.ints))(*plan.ints)
        rc = lib.uvc_dc_sort(buf.data_ptr(), N, A, ints, len(plan.ints),
                             scratch.data_ptr(), stream)
    kernels.check(lib, "dc_sort", rc)
    kernels.count("dc_sort")
    return plan


# ---- dc_segments --------------------------------------------------------------

def _starts(ok, keys):
    """Segment starts over sorted rows: ok rows whose keys differ from the
    previous row's, or whose previous row is not ok."""
    same = ok[1:] & ok[:-1]
    for k in keys:
        same = same & (k[1:] == k[:-1])
    return torch.cat([ok[:1], ok[1:] & ~same])


def _segment_ids(ok, start):
    """(id of each ok row's segment, with N - 1 for the others; count)."""
    N = ok.shape[0]
    seg_id = torch.cumsum(start.to(torch.int32), 0, dtype=torch.int32) - 1
    n = max(int(seg_id[-1]) + 1, 0) * int(bool(ok.any()))
    return torch.where(ok, seg_id, N - 1).long(), n


def _segment_reduce(idx, x, how, N, fill=0):
    out = torch.full((N,), fill, dtype=torch.int32, device=x.device)
    return out.scatter_reduce(0, idx, x, how, include_self=False)


def dc_segments_plain(stage, buf, mode_sum, ovr, out, buf2, counts):
    """Plain PyTorch version of ``dc_segments``, the JAX program's stage 1
    or stage 2 on the sorted table ``buf``."""
    N = buf.shape[1]
    ar = torch.arange(N, dtype=torch.int32, device=buf.device)
    zero = torch.zeros((), dtype=torch.int32, device=buf.device)
    if stage == 1:
        inval, g, p, s, _idx, v = buf
        ok = inval == 0
        seg, n_uniq = _segment_ids(ok, _starts(ok, (g, p, s)))
        red = _segment_reduce(seg, torch.where(ok, v, zero),
                              "sum" if mode_sum else "amax", N)
        uvalid = ar < n_uniq
        u = [torch.where(uvalid, _segment_reduce(
            seg, torch.where(ok, x, zero), "amax", N), zero)
            for x in (g, p, s)] + [torch.where(uvalid, red, zero)]
        out.copy_(torch.stack(u))
        counts[0] = n_uniq
        u_g, u_p, u_s, u_v = u
        u_st = (u_s >= 6).to(torch.int32)
        cvalid = uvalid & (u_v > 0)
        cls = ((u_s == int(Symbol.LINK_M)) & (u_st == 1)).to(torch.int32) \
            if ovr else torch.zeros_like(u_s)
        buf2.copy_(torch.stack([(~cvalid).to(torch.int32), u_g, u_p, u_st,
                                cls, -u_v, u_s, ar, u_v]))
        return
    c_inv, g, p, st, _cls, _negv, s, _idx, v = buf
    ok = c_inv == 0
    gstart = _starts(ok, (g, p, st))
    gid, n_grp = _segment_ids(ok, gstart)
    tot = _segment_reduce(gid, torch.where(ok, v, zero), "sum", N)
    first = _segment_reduce(gid, torch.where(gstart, ar, N), "amin", N, N)
    gvalid = ar < n_grp
    first = torch.where(gvalid, torch.clamp(first, max=N - 1), zero).long()
    c = [torch.where(gvalid, x[first], zero) for x in (g, p, st, s, v)]
    tot = torch.where(gvalid, tot, zero)
    if ovr:
        tot = torch.where((c[2] == 1) & gvalid, c[4], tot)
    out.copy_(torch.stack(c[:3] + [c[3], c[4], tot]))
    counts[1] = n_grp


def dc_segments(stage, buf, mode_sum, ovr, out, buf2, counts, scratch=None):
    """Stage 1: the unique rows of the sorted stage-1 table ``buf`` [6, N]
    into ``out`` [4, N] (ug, up, us, uv; zeros beyond n_uniq), n_uniq into
    ``counts[0]`` and the stage-2 table into ``buf2`` [9, N].  Stage 2:
    the consensus rows of the sorted stage-2 table ``buf`` into ``out``
    [6, N] (group, pos, st, con_sym, con_cnt, tot; zeros beyond n_grp) and
    n_grp into ``counts[1]``.  ``out`` comes zeroed.  The kernel on a CUDA
    tensor, the plain version on a CPU one.

    Returns the kernel's scratch (None on the CPU).  Stage 1 zeroes both
    stages' halves of it, so a stage 2 of the same N handed stage 1's
    ``scratch`` launches no memset of its own; hand it to one stage 2
    only, since a stage leaves its half used."""
    if stage not in (1, 2):
        raise ValueError(f"dc_segments: no stage {stage}")
    cols = COLS1 if stage == 1 else COLS2
    N = _check_table(f"dc_segments {stage}", buf, (len(cols),))
    tables = [(out, "out", 4 if stage == 1 else 6, N)]
    if stage == 1:
        tables.append((buf2, "buf2", len(COLS2), N))
    for t, nm, rows, n in tables:
        if (t.dtype != torch.int32 or tuple(t.shape) != (rows, n)
                or not t.is_contiguous() or t.device != buf.device):
            raise ValueError(f"dc_segments: {nm} must be a contiguous int32 "
                             f"[{rows}, {n}] table on {buf.device}")
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (2,)
            or counts.device != buf.device):
        raise ValueError("dc_segments: counts must be int32 [2] on "
                         f"{buf.device}")
    if buf.device.type == "cpu":
        return dc_segments_plain(stage, buf, mode_sum, ovr, out, buf2,
                                 counts)
    from ..kernels import build
    lib = build.load()
    nbytes = lib.uvc_dc_segments_scratch(N)
    zeroed = scratch is not None and stage == 2
    if scratch is None:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=buf.device)
    elif (scratch.dtype != torch.uint8 or tuple(scratch.shape) != (nbytes,)
          or scratch.device != buf.device):
        raise ValueError(f"dc_segments: scratch must be stage 1's uint8 "
                         f"[{nbytes}] on {buf.device}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
        if stage == 1:
            rc = lib.uvc_dc_segments_unique(
                buf.data_ptr(), N, int(mode_sum), int(ovr), out.data_ptr(),
                buf2.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                stream)
        else:
            rc = lib.uvc_dc_segments_groups(
                buf.data_ptr(), N, int(ovr), out.data_ptr(),
                counts.data_ptr(), scratch.data_ptr(), int(zeroed), stream)
    kernels.check(lib, "dc_segments", rc)
    kernels.count("dc_segments")
    return scratch


# ---- the program ----------------------------------------------------------------

def stage1_table(group, pos, sym, val):
    """The stage-1 table [6, N] (host numpy int32) of n event rows; the
    int32 casts wrap as the JAX program's ``astype(i32)`` does."""
    n = len(group)
    N = _bucket(max(n, 1))
    t = np.zeros((len(COLS1), N), dtype=np.int32)
    t[0, n:] = 1
    for r, a in ((1, group), (2, pos), (3, sym), (5, val)):
        t[r, :n] = np.asarray(a, dtype=np.int64).astype(np.int32)
    t[4] = np.arange(N, dtype=np.int32)
    return t


def reduce_consensus(buf1, mode, link_m_overridden):
    """The program on the stage-1 table ``buf1`` (sorted in place) on its
    device: (out_u [4, N], out_c [6, N], counts [2]) as device tensors."""
    N = buf1.shape[1]
    kw = dict(dtype=torch.int32, device=buf1.device)
    out_u = torch.zeros((4, N), **kw)
    out_c = torch.zeros((6, N), **kw)
    buf2 = torch.empty((len(COLS2), N), **kw)
    counts = torch.zeros(2, **kw)
    mode_sum = mode != "max"
    dc_sort(buf1, NKEYS1)
    scratch = dc_segments(1, buf1, mode_sum, link_m_overridden, out_u, buf2,
                          counts)
    dc_sort(buf2, NKEYS2)
    dc_segments(2, buf2, mode_sum, link_m_overridden, out_c, None, counts,
                scratch)
    return out_u, out_c, counts


def device_reduce_consensus(group, pos, sym, val, P, mode,
                            link_m_overridden):
    """Host wrapper, as the JAX package's: pad to a power-of-two bucket, run
    the program on ``DEVICE``, slice to the true counts.  Returns
    ((ugroup, upos, usym, uval), (group, pos, st, con_sym, con_cnt, tot))
    as int64 arrays, matching pileup/consensus.reduce_and_consensus row
    for row.  ``P`` is unused, as in the JAX program's shapes.  Raises
    where ``DEVICE`` is a CUDA device and there is no card."""
    del P
    if DEVICE.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_reduce_consensus: DEVICE is a CUDA device "
                           "but torch.cuda.is_available() is false")
    table = stage1_table(group, pos, sym, val)
    with _LOCK:
        STATS["calls"] += 1
        STATS["rows"] += len(group)
        buf1 = torch.from_numpy(table).to(DEVICE)
        out_u, out_c, counts = reduce_consensus(buf1, mode,
                                                bool(link_m_overridden))
        nu, ng = (int(x) for x in counts.cpu())
        uniq = out_u[:, :nu].cpu().numpy().astype(np.int64)
        cons = out_c[:, :ng].cpu().numpy().astype(np.int64)
    return tuple(uniq), tuple(cons)
