"""The family chain of host prepare on the card.

The host route (pileup/region.py) runs the chain on its statics path as
two native calls (ops/native_rowpile.py, native/rowpile.cpp):
``frag_cons_with_pass_d`` merges each fragment's read streams (the max
per (pos, sym) over its reads, then the consensus rule per (pos, symbol
type)) and runs pass D in the flush of each fragment, and
``fam_chain_statics`` merges the fragments of each family, runs sweep 1
on the count consensus and sweep 2 on the stored rows.  This module
gives the same chain a device route: three kernels of
kernels/csrc/family_chain.cu (the fragment merge with pass D, the family
merge with sweep 1, sweep 2), with the fragment consensus rows kept on
the card between them, one upload a region on the calling worker thread's
own CUDA stream, and a readback of two copies: the planes with the row
counts, then the rows (packed in one slot by the kernels).  Both go
through grow-only pinned buffers of the worker thread; the arrays
returned are ordinary host memory.  Where pass C ran on the card
(pileup/device_pass_c.py), the chain reads the event columns, bg and aDP4
where that launch left them (SHARED: not uploaded again), and its first
readback copy brings pass C's planes back too.  It returns the host's
arrays, row tables in the host's order:

  - pass D: bdp, bta, btb [P,14,2], hist [P,14,16] and vq_bMQ [P,14]
    (int32), the mut rows (frag, pos, st, sym), the win rows
    (frag, pos, sym);
  - the family chain: cdp12, cdp21, cdp2, cdp3, cdpm, cdpM, cdp1 [P,14,2]
    and hist [2,P,14,16] (int32), fbeg and fend [n_fams] (int64), the
    good rows (g, pos, st, sym, cnt, tot), the m2 rows
    (g, pos, st, sym, ok).

Beside each kernel is its plain PyTorch version (``frag_merge_plain``,
``fam_merge_plain``, ``sweep2_plain``): ``run`` takes them on a CPU device
and the kernels on a CUDA device.  Where the input would send the host
off its statics path (events out of read-major key order, a fragment of
more than 8 reads, ...), or where a rounded use of realphred lies within
1e-9 of a .5 (CUDA's and the host's log may differ in the last place),
``run`` returns None and the caller takes the host route.

``DEVICE`` is where the route runs: the CLI sets it from ``--device``, as
ops/device_consensus.DEVICE.  ``route_device`` takes the route only on a
card (``ROUTE_TYPES``) and never for the consensus FASTQ output or under
UVC_TPU_DEVICE_PREPARE=1; the caller also keeps duplex-flagged families
on the host, as engine_fq.run_fq keeps them off the statics path.

Test hooks, set by tests alone: ``ROUTE_TYPES`` (the CPU tests add
``"cpu"`` to run the route through its plain versions) and ``launch``'s
``sync_each`` (the card test synchronises after each kernel).

``fq_result`` is engine_fq._run_fq_statics after its native chain, line
for line over the chain's arrays (tests/test_torch_family_chain.py holds
the two equal).
"""

import ctypes
import math
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..constants import NUM_SYMBOLS

NS = NUM_SYMBOLS
NBUCKETS = 16
DEVICE = torch.device("cpu")
ROUTE_TYPES = ("cuda",)

MAX_READS = 8       # reads a fragment (the host merge's limit)
MAX_STREAMS = 8     # event streams a region
MAX_FAM = 128       # fragments a family the k-way merge takes
NPOW10 = 1024       # avgBQ values of the pow(10, -q/10) table
INV_LOG10 = 10.0 / math.log(10.0)
POW10 = np.array([math.pow(10.0, -q / 10.0) for q in range(NPOW10)])

# error bits (csrc/family_chain.cu Err): each sends a region to the host
E_EVENTS, E_READS, E_DUP, E_ROWS, E_ROUND, E_AVGBQ, E_FAMSIZE = (
    1, 2, 4, 8, 16, 32, 64)

# the kernel arena's slots (csrc/family_chain.cu Slot, in order): name,
# dtype, and the element count as a function of the region's sizes
_N = lambda d: d["n"]                                   # noqa: E731
SLOTS = (
    ("pos", np.int32, _N), ("sym", np.int8, _N), ("val", np.int32, _N),
    ("read", np.int32, _N),
    ("bg", np.int64, lambda d: d["P"] * NS),
    ("adp4", np.int64, lambda d: d["P"] * NS),
    ("stream_off", np.int32, lambda d: d["S"] + 1),
    ("frag_off", np.int32, lambda d: d["F"] + 1),
    ("frag_read", np.int32, lambda d: d["R"]),
    ("frag_strand", np.int32, lambda d: d["F"]),
    ("mq2", np.int32, lambda d: d["F"]),
    ("fam_off", np.int32, lambda d: d["NF"] + 1),
    ("fam_frag", np.int32, lambda d: d["F"]),
    ("fam_strand", np.int32, lambda d: d["NF"]),
    ("fam_dflag", np.int32, lambda d: d["NF"]),
    ("ref", np.int32, lambda d: d["P"]),
    ("sscs", np.int32, lambda d: NS * NS),
    ("pow10", np.float64, lambda d: NPOW10),
    # zeroed; bdp .. counts read back in one copy
    ("bdp", np.int32, lambda d: d["P"] * NS * 2),
    ("bta", np.int32, lambda d: d["P"] * NS * 2),
    ("btb", np.int32, lambda d: d["P"] * NS * 2),
    ("hist_d", np.int32, lambda d: d["P"] * NS * NBUCKETS),
    ("vq_bmq", np.int32, lambda d: d["P"] * NS),
    ("cdp12", np.int32, lambda d: d["P"] * NS * 2),
    ("cdp21", np.int32, lambda d: d["P"] * NS * 2),
    ("cdp2", np.int32, lambda d: d["P"] * NS * 2),
    ("cdp3", np.int32, lambda d: d["P"] * NS * 2),
    ("cdpm_minor", np.int32, lambda d: d["P"] * NS * 2),
    ("cdpm_major", np.int32, lambda d: d["P"] * NS * 2),
    ("cdp1", np.int32, lambda d: d["P"] * NS * 2),
    ("hist_f", np.int32, lambda d: 2 * d["P"] * NS * NBUCKETS),
    ("fbeg", np.int64, lambda d: d["NF"]),
    ("fend", np.int64, lambda d: d["NF"]),
    ("counts", np.int32, lambda d: 8),
    ("il", np.int32, lambda d: d["P"] * NS * 2 * 7),
    ("fam_m2n", np.int32, lambda d: d["NF"] + 1),
    # scratch
    ("soff", np.int32, lambda d: d["S"] * (d["R"] + 1)),
    ("frag_cnt", np.int32, lambda d: 3 * (d["F"] + 1)),
    ("frag_offs", np.int32, lambda d: 3 * (d["F"] + 1)),
    ("cons", np.int32, lambda d: 6 * d["n"]),
    ("rowmut", np.uint8, _N),
    ("fam_cnt", np.int32, lambda d: 2 * (d["NF"] + 1)),
    ("fam_offs", np.int32, lambda d: 2 * (d["NF"] + 1)),
    ("fam_m2off", np.int32, lambda d: d["NF"] + 1),
    ("s2", np.int32, lambda d: 7 * d["n"]),
    ("s2flag", np.uint8, _N),
    # the row tables read back (ROW_TABLES), packed by their counts
    ("rows", np.int32, lambda d: 18 * d["n"]),
)
SLOT = {nm: i for i, (nm, _, _) in enumerate(SLOTS)}
INPUTS = tuple(nm for nm, _, _ in SLOTS[:SLOT["bdp"]])
# the inputs a launch of pass C (pileup/device_pass_c.py) leaves on the card
SHARED = INPUTS[:SLOT["stream_off"]]
PARAMS = ("P", "n", "S", "R", "F", "NF", "highbq", "mut_window",
          "highbq_snv", "pdel_ign", "dup1add", "dup1perc", "dup2add",
          "dup2perc", "flag2", "emperr_snv", "emperc_snv", "emperr_indel",
          "emperc_indel", "rescue_add", "indel_inc", "npow10")
# counts[] (csrc Count)
C_ERR, C_OUT, C_MUT, C_WIN, C_S2, C_G1, C_M2 = range(7)
# the tables of the rows slot, in order (csrc Table): name, count, columns
ROW_TABLES = (("mut", C_MUT, 4), ("win", C_WIN, 3), ("g1", C_G1, 6),
              ("m2", C_M2, 5))
FAM_PLANES = ("cdp12", "cdp21", "cdp2", "cdp3", "cdpm", "cdpM", "cdp1")
# kernels of one region's chain, by launches (kernels.LAUNCHES)
CHAIN_LAUNCHES = {"frag_merge": 4, "fam_merge": 2, "sweep2": 3,
                  "chain_scan": 3}


def route_device(cfg):
    """The device of the region's family chain, or None for the host
    route (a CPU ``DEVICE``, the consensus FASTQ, on-device prepare)."""
    if DEVICE.type not in ROUTE_TYPES:
        return None
    if cfg.fam_consensus_out_fastq:
        return None
    if os.environ.get("UVC_TPU_DEVICE_PREPARE", "") == "1":
        return None
    return DEVICE


# ---- the chain's input ------------------------------------------------------

def rescue_add(cfg):
    """engine_fq's rescue_add: 4 in a leg that reads a tumor VCF."""
    return 0 if cfg.vcf_tumor_fname in (".", "") else 4



@dataclass
class ChainInput:
    """Everything the chain reads for one region (the host's arrays)."""
    pos: np.ndarray
    sym: np.ndarray
    val: np.ndarray
    read: np.ndarray
    stream_off: np.ndarray
    frag_of_read: np.ndarray
    n_frags: int
    fam_of_frag: np.ndarray
    n_fams: int
    fam_strand: np.ndarray
    fam_dflag: np.ndarray
    frag_strand: np.ndarray
    normMQ: np.ndarray
    bg: np.ndarray
    aDP4: np.ndarray
    ref_syms: np.ndarray
    sscs: np.ndarray
    prm: dict = field(default_factory=dict)

    @property
    def P(self):
        return len(self.ref_syms)


def chain_input(allev, famgrp, table, info, bg, ref_syms, sscs_table, cfg):
    """The chain's input as pileup/region.py and engine_fq hand it to the
    native calls; ``info`` and ``bg`` None where pass C's planes are still
    on the card (its launch holds bg and aDP4 there)."""
    from .engine_fq import _pdel_ignored
    normMQ = np.zeros(famgrp.n_frags, dtype=np.int64)
    if famgrp.n_frags:
        np.maximum.at(normMQ, famgrp.frag_of_read, table.reads.mapq)
    aDP4 = (None if info is None
            else info.aDPff + info.aDPfr + info.aDPrf + info.aDPrr)
    prm = dict(
        highbq=cfg.bias_thres_highBQ,
        mut_window=cfg.syserr_mut_region_n_bases,
        highbq_snv=cfg.fam_thres_highBQ_snv, pdel_ign=_pdel_ignored(cfg),
        dup1add=cfg.fam_thres_dup1add, dup1perc=cfg.fam_thres_dup1perc,
        dup2add=cfg.fam_thres_dup2add, dup2perc=cfg.fam_thres_dup2perc,
        fam_flag=cfg.fam_flag,
        emperr_snv=cfg.fam_thres_emperr_all_flat_snv,
        emperc_snv=cfg.fam_thres_emperr_con_perc_snv,
        emperr_indel=cfg.fam_thres_emperr_all_flat_indel,
        emperc_indel=cfg.fam_thres_emperr_con_perc_indel,
        rescue_add=rescue_add(cfg),
        indel_inc=cfg.fam_phred_indel_inc_before_barcode_labeling)
    return ChainInput(
        pos=allev.pos, sym=allev.sym, val=allev.val, read=allev.read,
        stream_off=allev.stream_off, frag_of_read=famgrp.frag_of_read,
        n_frags=int(famgrp.n_frags), fam_of_frag=famgrp.fam_of_frag,
        n_fams=int(famgrp.n_fams), fam_strand=famgrp.fam_strand,
        fam_dflag=famgrp.fam_dflag, frag_strand=famgrp.frag_strand,
        normMQ=normMQ, bg=bg, aDP4=aDP4, ref_syms=ref_syms,
        sscs=sscs_table, prm=prm)


UMI_VARIANTS = ("umi", "umi_rescued", "fam_flag2")


def umi_variant(ci, variant):
    """``ci``'s fragments grouped into single-strand UMI families of 1-8
    fragments (ids shuffled, so members are not neighbours), the input
    of the family merge's k-way path: ``umi``; ``umi_rescued`` with
    rescue_add 4; ``fam_flag2`` with fam_flag 0x2 and no family flagged
    (good rows without UMIs).  Seeded by the variant."""
    import dataclasses
    rng = np.random.default_rng(UMI_VARIANTS.index(variant) + 11)
    sizes = rng.integers(1, 9, size=ci.n_frags)
    fam = np.repeat(np.arange(ci.n_frags), sizes)[:ci.n_frags]
    fam = rng.permutation(int(fam.max()) + 1)[fam].astype(np.int64)
    nf = int(fam.max()) + 1
    prm = dict(ci.prm)
    dflag = np.ones(nf, dtype=np.int64)
    if variant == "umi_rescued":
        prm["rescue_add"] = 4
    if variant == "fam_flag2":
        prm["fam_flag"] = 0x2
        dflag[:] = 0
    return dataclasses.replace(
        ci, fam_of_frag=fam, n_fams=nf, fam_dflag=dflag, prm=prm,
        fam_strand=rng.integers(0, 2, nf).astype(np.int64))


@dataclass
class ChainOutput:
    """The chain's arrays, as the host route returns them."""
    pass_d: tuple       # (bdp, bta, btb, hist, vq_bMQ, mut rows, win rows)
    planes: dict        # FAM_PLANES -> [P,14,2] int32
    hist: np.ndarray    # [2,P,14,16] int32
    fbeg: np.ndarray
    fend: np.ndarray
    good: tuple         # 6 int64 arrays
    m2: tuple           # 5 int64 arrays


def differences(want, got):
    """The names of the arrays in which two ChainOutputs differ (values,
    dtype or length; row tables column by column); [] when they agree
    array for array."""
    out = []
    names = ("bdp", "bta", "btb", "hist_d", "vq_bMQ")
    pairs = list(zip(names, want.pass_d[:5], got.pass_d[:5]))
    pairs += [(nm, want.planes[nm], got.planes[nm]) for nm in FAM_PLANES]
    pairs += [(nm, getattr(want, nm), getattr(got, nm))
              for nm in ("hist", "fbeg", "fend")]
    for nm, a, b in (("mut", want.pass_d[5], got.pass_d[5]),
                     ("win", want.pass_d[6], got.pass_d[6]),
                     ("good", want.good, got.good), ("m2", want.m2, got.m2)):
        if len(a) != len(b):
            out.append(nm)
            continue
        pairs += [(f"{nm}[{c}]", x, y) for c, (x, y) in enumerate(zip(a, b))]
    for nm, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            out.append(nm)
    return out


def native_chain(ci):
    """The host route's statics path (frag_cons_with_pass_d, then
    fam_chain_statics), the reference of the route; None where it leaves
    that path."""
    from types import SimpleNamespace
    from ..ops import native_rowpile as nr
    p = ci.prm
    P = ci.P
    if not nr.has_statics_path():
        return None
    allev = SimpleNamespace(pos=ci.pos, sym=ci.sym, val=ci.val, read=ci.read,
                            stream_off=ci.stream_off)
    fused = nr.frag_cons_with_pass_d(
        allev, ci.frag_of_read, ci.n_frags, P, ci.bg, ci.aDP4, ci.ref_syms,
        ci.frag_strand, ci.normMQ, p["highbq"], p["mut_window"])
    if fused is None:
        return None
    _, pass_d = fused
    famgrp = SimpleNamespace(n_fams=ci.n_fams, fam_of_frag=ci.fam_of_frag,
                             fam_strand=ci.fam_strand,
                             fam_dflag=ci.fam_dflag)
    cfg = SimpleNamespace(
        fam_thres_highBQ_snv=p["highbq_snv"],
        fam_thres_dup1add=p["dup1add"], fam_thres_dup1perc=p["dup1perc"],
        fam_thres_dup2add=p["dup2add"], fam_thres_dup2perc=p["dup2perc"],
        fam_flag=p["fam_flag"],
        fam_thres_emperr_all_flat_snv=p["emperr_snv"],
        fam_thres_emperr_con_perc_snv=p["emperc_snv"],
        fam_thres_emperr_all_flat_indel=p["emperr_indel"],
        fam_thres_emperr_con_perc_indel=p["emperc_indel"],
        fam_phred_indel_inc_before_barcode_labeling=p["indel_inc"],
        bias_thres_highBQ=p["highbq"])
    planes = {nm: np.zeros((P, NS, 2), dtype=np.int32) for nm in FAM_PLANES}
    hist = np.zeros((2, P, NS, NBUCKETS), dtype=np.int32)
    fused = nr.fam_chain_statics(
        famgrp, P, cfg, ci.ref_syms, ci.sscs, p["rescue_add"],
        planes["cdp12"], planes["cdp21"], planes["cdp2"], planes["cdp3"],
        planes["cdpm"], planes["cdpM"], planes["cdp1"], hist,
        pdel_ign=p["pdel_ign"])
    if fused is None:
        return None
    good, m2, fbeg, fend = fused
    return ChainOutput(pass_d=pass_d, planes=planes, hist=hist, fbeg=fbeg,
                       fend=fend, good=good, m2=m2)


def stage(ci, out=None):
    """The chain's inputs in the kernels' types, as (sizes, {slot: array}):
    the event columns narrowed to int32 (sym to int8), the fragment and
    family maps as CSR (members in id order, as the host's counting sorts
    give them).  ``out`` ({slot: array view}) receives the columns in
    place (the pinned staging buffer), and only those it holds (not
    SHARED where pass C's launch holds them); else they are new arrays,
    every input.  None where the region does not fit the kernels (too
    many streams, a map out of range, an event column outside [0, 2^31)
    that int32 would wrap, no rows)."""
    n, S = len(ci.pos), len(ci.stream_off) - 1
    R, F, NF, P = len(ci.frag_of_read), ci.n_frags, ci.n_fams, ci.P
    if not (0 < n < 2**31 - 1 and 0 < S <= MAX_STREAMS and R > 0 and F > 0
            and NF > 0 and 0 < P < 2**27 and len(ci.fam_of_frag) == F):
        return None
    names = INPUTS if out is None else tuple(out)
    if any(np.bitwise_or.reduce(getattr(ci, c)) >> 31
           for c in ("pos", "val", "read") if c in names):
        return None
    fr, ff = ci.frag_of_read, ci.fam_of_frag
    if fr.min() < 0 or fr.max() >= F or ff.min() < 0 or ff.max() >= NF:
        return None
    sizes = dict(n=n, S=S, R=R, F=F, NF=NF, P=P)
    frag_read = np.argsort(fr, kind="stable")
    frag_off = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(np.bincount(fr, minlength=F), out=frag_off[1:])
    fam_frag = np.argsort(ff, kind="stable")
    fam_off = np.zeros(NF + 1, dtype=np.int64)
    np.cumsum(np.bincount(ff, minlength=NF), out=fam_off[1:])
    src = dict(
        pos=ci.pos, sym=ci.sym, val=ci.val, read=ci.read,
        stream_off=ci.stream_off, frag_off=frag_off, frag_read=frag_read,
        frag_strand=ci.frag_strand, mq2=ci.normMQ * ci.normMQ // 32,
        fam_off=fam_off, fam_frag=fam_frag, fam_strand=ci.fam_strand,
        fam_dflag=ci.fam_dflag, bg=ci.bg, adp4=ci.aDP4, ref=ci.ref_syms,
        sscs=ci.sscs.reshape(-1), pow10=POW10)
    staged = {}
    for nm, dt, cnt in SLOTS[:len(INPUTS)]:
        if nm not in names:
            continue
        dst = out[nm] if out is not None else np.empty(cnt(sizes), dt)
        np.copyto(dst, src[nm].reshape(-1), casting="unsafe")
        staged[nm] = dst
    return sizes, staged


def params(ci, sizes):
    p = ci.prm
    vals = dict(sizes, flag2=1 if p["fam_flag"] & 0x2 else 0,
                npow10=NPOW10, **{k: p[k] for k in (
                    "highbq", "mut_window", "highbq_snv", "pdel_ign",
                    "dup1add", "dup1perc", "dup2add", "dup2perc",
                    "emperr_snv", "emperc_snv", "emperr_indel",
                    "emperc_indel", "rescue_add", "indel_inc")})
    return [int(vals[k]) for k in PARAMS]


def run(ci, device, pass_c=None):
    """The chain of one region on ``device`` (plain versions on a CPU
    device, the kernels on a card, reading SHARED where ``pass_c``, a
    launch of pass C on the card, holds them); None where the region must
    take the host route."""
    if device.type == "cpu":
        st = stage(ci)
        if st is None:
            return None
        return _run_plain(ci, *st)
    return _run_kernels(ci, device, pass_c)


# ---- the plain versions ----------------------------------------------------

def _wrap32(t):
    """int64 sums as the int32 counters of the host and the kernels hold
    them (two's complement)."""
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


def _lexsort(*cols):
    """The permutation that sorts by cols[0], then cols[1], ... stably."""
    perm = torch.arange(len(cols[0]))
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _seg_first_max(gid, G, v, ok):
    """(max of v over the rows with ok of each segment, -1 where none;
    the index of its first row, -1 where none)."""
    mx = torch.full((G,), -1, dtype=torch.int64)
    mx.scatter_reduce_(0, gid[ok], v[ok], "amax")
    cand = ok & (v == mx[gid])
    big = len(v)
    first = torch.full((G,), big, dtype=torch.int64)
    first.scatter_reduce_(0, gid[cand], torch.arange(len(v))[cand], "amin")
    return mx, torch.where(first < big, first, torch.full_like(first, -1))


def _starts(*cols):
    """True where any of cols differs from the row before (and row 0)."""
    m = len(cols[0])
    s = torch.ones(m, dtype=torch.bool)
    if m > 1:
        d = torch.zeros(m - 1, dtype=torch.bool)
        for c in cols:
            d |= c[1:] != c[:-1]
        s[1:] = d
    return s


def frag_merge_plain(st, sizes, prm):
    """The fragment merge with pass D (fc_offsets, fc_merge, fc_tail) on
    the staged inputs, as torch int64 tensors: (err, cons rows (f, pos,
    st, cs, cc, tot), the rows' mut flags, pass D's planes
    (bdp, bta, btb, hist, vq_bMQ), mut rows, win rows)."""
    T = {k: torch.as_tensor(np.asarray(v)).to(torch.int64)
         for k, v in st.items()}
    S, R, F, P = (sizes[k] for k in ("S", "R", "F", "P"))
    pos, sym, val, read = T["pos"], T["sym"], T["val"], T["read"]
    so = T["stream_off"]
    key = pos * 16 + sym
    stream = torch.repeat_interleave(torch.arange(S), so[1:] - so[:-1])
    ok = ((read >= 0) & (read < R) & (pos >= 0) & (pos < P) & (sym >= 0)
          & (sym < NS) & (val >= 0))
    same = stream[1:] == stream[:-1]
    bad = same & ((read[1:] < read[:-1])
                  | ((read[1:] == read[:-1]) & (key[1:] <= key[:-1])))
    if not bool(ok.all()) or bool(bad.any()):
        return E_EVENTS, None
    foff, fread = T["frag_off"], T["frag_read"]
    nmem = foff[1:] - foff[:-1]
    if int(nmem.max()) > MAX_READS:
        return E_READS, None
    csr_frag = torch.repeat_interleave(torch.arange(F), nmem)
    frag_of_read = torch.empty(R, dtype=torch.int64)
    frag_of_read[fread] = csr_frag
    f = frag_of_read[read]
    # each read's rows: nonempty, first and last key
    nonempty = torch.bincount(read, minlength=R) > 0
    first = torch.full((R,), 2**40, dtype=torch.int64)
    first.scatter_reduce_(0, read, key, "amin")
    last = torch.full((R,), -1, dtype=torch.int64)
    last.scatter_reduce_(0, read, key, "amax")
    # each fragment's nonempty member reads, in member order
    ne = nonempty[fread].to(torch.int64)
    ex = torch.cumsum(ne, 0) - ne
    rank = ex - ex[foff[:-1]][csr_frag]
    nr = torch.zeros(F, dtype=torch.int64).index_add_(0, csr_frag, ne)
    r0 = torch.zeros(F, dtype=torch.int64)
    r1 = torch.zeros(F, dtype=torch.int64)
    sel = (ne == 1) & (rank == 0)
    r0[csr_frag[sel]] = fread[sel]
    sel = (ne == 1) & (rank == 1)
    r1[csr_frag[sel]] = fread[sel]
    f0, l0, f1, l1 = first[r0], last[r0], first[r1], last[r1]
    split = (nr == 2) & ((l0 < f1) | (l1 < f0))
    unit_a = torch.where(f1 < f0, r1, r0)
    single = (nr == 1) | split
    u = (split[f] & (read != unit_a[f])).to(torch.int64)
    # the merge: rows by (fragment, unit, key), a key's max over its reads
    perm = _lexsort(f, u, key, read)
    fs, us, ks, rs, vs = f[perm], u[perm], key[perm], read[perm], val[perm]
    kst = _starts(fs, us, ks)
    if bool((~_starts(fs, us, ks, rs)).any()):
        return E_DUP, None
    kid = torch.cumsum(kst.to(torch.int64), 0) - 1
    nk = int(kid[-1]) + 1
    acc = torch.full((nk,), -2**40, dtype=torch.int64)
    acc.scatter_reduce_(0, kid, vs, "amax")
    uf, uk = fs[kst], ks[kst]
    upos, usym = uk // 16, uk % 16
    ust = (usym >= 6).to(torch.int64)
    # the consensus groups: (pos, st), a base row alone in a single unit
    alone = single[uf] & (ust == 0)
    gst_ = _starts(uf, us[kst], upos, ust) | alone
    gid = torch.cumsum(gst_.to(torch.int64), 0) - 1
    G = int(gid[-1]) + 1
    pos_acc = acc > 0
    tot = torch.zeros(G, dtype=torch.int64).index_add_(
        0, gid, torch.where(pos_acc, acc, torch.zeros_like(acc)))
    is_lm = (ust == 1) & (usym == 6)
    bv, bi = _seg_first_max(gid, G, acc, pos_acc & ~is_lm)
    lm = torch.zeros(G, dtype=torch.int64)
    sel = pos_acc & is_lm
    lm[gid[sel]] = acc[sel]
    gf, gp, gs = uf[gst_], upos[gst_], ust[gst_]
    has = bi >= 0
    cs = torch.where(has, usym[bi.clamp(min=0)], torch.full_like(bi, 6))
    cc = torch.where(has, bv, lm)
    tt = torch.where(gs == 1, cc, tot)
    emit = tot > 0
    cf, cp, cst, ccs, ccc, ctt = (x[emit] for x in (gf, gp, gs, cs, cc, tt))
    cc32 = _wrap32(ccc).to(torch.int64)
    tt32 = _wrap32(ctt).to(torch.int64)
    # pass D
    idx = cp * NS + ccs
    cq = cc32 * 2 - tt32
    bg, adp4 = T["bg"], T["adp4"]
    maxq = 8 + torch.div(bg[idx], adp4[idx].clamp(min=1),
                         rounding_mode="trunc")
    pb = (maxq - torch.minimum(cq, maxq)).clamp(min=0)
    strand = T["frag_strand"][cf]
    one = torch.ones_like(idx)
    h = pb < NBUCKETS
    hist = torch.zeros(P * NS * NBUCKETS, dtype=torch.int64).index_add_(
        0, (idx * NBUCKETS + pb)[h], one[h])
    bdp = torch.zeros(P * NS * 2, dtype=torch.int64).index_add_(
        0, idx * 2 + strand, one)
    vq = torch.zeros(P * NS, dtype=torch.int64).index_add_(
        0, idx, T["mq2"][cf])
    rs_ = T["ref"][cp]
    mut = torch.where(
        cst == 0,
        (rs_ != ccs) & (rs_ < 4) & (ccs < 4) & (cq >= prm["highbq"]),
        (ccs != 6) & (ccs != 13))
    win = (cst == 1) & (ccs >= 7) & (ccs <= 12)
    newpos = _starts(cf, cp)
    ncov = torch.zeros(F, dtype=torch.int64).index_add_(
        0, cf, newpos.to(torch.int64))
    W = prm["mut_window"]
    BIG = 2**32
    mkeys = torch.unique(cf[mut] * BIG + cp[mut])
    q = cf[newpos] * BIG + cp[newpos]
    near = torch.zeros(len(q), dtype=torch.bool)
    if len(mkeys):
        j = torch.searchsorted(mkeys, q - W)
        jc = j.clamp(max=len(mkeys) - 1)
        near = (j < len(mkeys)) & (mkeys[jc] <= q + W)
    nnear = torch.zeros(F, dtype=torch.int64).index_add_(
        0, cf[newpos], near.to(torch.int64))
    bt = idx * 2 + strand
    bta = torch.zeros(P * NS * 2, dtype=torch.int64).index_add_(
        0, bt, ncov[cf])
    btb = torch.zeros(P * NS * 2, dtype=torch.int64).index_add_(
        0, bt, nnear[cf])
    cons = (cf, cp, cst, ccs, cc32, tt32)
    planes = (_wrap32(bdp).reshape(P, NS, 2), _wrap32(bta).reshape(P, NS, 2),
              _wrap32(btb).reshape(P, NS, 2),
              _wrap32(hist).reshape(P, NS, NBUCKETS),
              _wrap32(vq).reshape(P, NS))
    return 0, (cons, mut, planes, (cf[mut], cp[mut], cst[mut], ccs[mut]),
               (cf[win], cp[win], ccs[win]))


def fam_merge_plain(cons, st, sizes, prm):
    """The family merge with sweep 1 (fam_merge) over the consensus rows:
    (err, the interleaved counters [P*14*2, 7] after sweep 1, fbeg, fend,
    s2 rows (g, pos, meta, cc, tt, cnf, tnf), good rows)."""
    P, F, NF = sizes["P"], sizes["F"], sizes["NF"]
    cf, cp, cst, ccs, ccc, ctt = cons
    foff = torch.as_tensor(np.asarray(st["fam_off"])).to(torch.int64)
    ffr = torch.as_tensor(np.asarray(st["fam_frag"])).to(torch.int64)
    fam_strand = torch.as_tensor(np.asarray(st["fam_strand"])).to(torch.int64)
    fam_dflag = torch.as_tensor(np.asarray(st["fam_dflag"])).to(torch.int64)
    famsize = foff[1:] - foff[:-1]
    fam_of_frag = torch.empty(F, dtype=torch.int64)
    fam_of_frag[ffr] = torch.repeat_interleave(torch.arange(NF), famsize)
    key = cp * 16 + ccs
    if len(cf) > 1:
        same = cf[1:] == cf[:-1]
        if bool((same & (key[1:] <= key[:-1])).any()):
            return E_ROWS, None
    if int(famsize[famsize > 1].numel()) and int(famsize.max()) > MAX_FAM:
        return E_FAMSIZE, None
    # extents: a fragment's rows are key-sorted, so its first and last
    # row give its extent
    nrow = torch.bincount(cf, minlength=F)
    fro = torch.zeros(F + 1, dtype=torch.int64)
    fro[1:] = torch.cumsum(nrow, 0)
    has = nrow > 0
    fams = fam_of_frag[has]
    fbeg = torch.full((NF,), 2**63 - 1, dtype=torch.int64)
    fbeg.scatter_reduce_(0, fams, cp[fro[:-1][has]], "amin")
    fend = torch.full((NF,), -1, dtype=torch.int64)
    fend.scatter_reduce_(0, fams, cp[fro[1:][has] - 1], "amax")
    fm = fam_of_frag[cf]
    adj = 2 * ccc - ctt
    keep = adj > 0
    a1 = (keep & ((cst == 1) | ((adj >= prm["highbq_snv"])
                               & ~((prm["pdel_ign"] != 0) & (ccs >= 4)))))
    a1 = a1.to(torch.int64)
    # rows with adj > 0, by (family, key); a family of one fragment keeps
    # each row a group of its own (the host's per-row path)
    sel = torch.nonzero(keep).flatten()
    perm = sel[_lexsort(fm[sel], key[sel])]
    kf, kk, ka1, kadj = fm[perm], key[perm], a1[perm], adj[perm]
    kone = famsize[kf] == 1
    kst = _starts(kf, kk) | kone
    kid = torch.cumsum(kst.to(torch.int64), 0) - 1
    nk = int(kid[-1]) + 1 if len(kid) else 0
    acc1 = torch.zeros(nk, dtype=torch.int64).index_add_(0, kid, ka1)
    acc2 = torch.zeros(nk, dtype=torch.int64).index_add_(0, kid, kadj)
    uf, uk, uone = kf[kst], kk[kst], kone[kst]
    upos, usym = uk // 16, uk % 16
    ust = (usym >= 6).to(torch.int64)
    gst_ = _starts(uf, upos, ust) | uone
    gid = torch.cumsum(gst_.to(torch.int64), 0) - 1
    G = int(gid[-1]) + 1 if len(gid) else 0
    t1 = torch.zeros(G, dtype=torch.int64).index_add_(0, gid, acc1)
    t2 = torch.zeros(G, dtype=torch.int64).index_add_(0, gid, acc2)
    bv1, bi1 = _seg_first_max(gid, G, acc1, acc1 > 0)
    bv2, bi2 = _seg_first_max(gid, G, acc2, acc2 > 0)
    gf, gp, gs = uf[gst_], upos[gst_], ust[gst_]
    strand = fam_strand[gf]
    fam_ok = ((fam_dflag[gf] & 1) != 0) | bool(prm["fam_flag"] & 0x2)
    il = torch.zeros((P * NS * 2, 7), dtype=torch.int64)
    s1 = t1 > 0
    cs1, cc1 = usym[bi1.clamp(min=0)], bv1
    idx = (gp * NS + cs1) * 2 + strand
    good = (s1 & (t1 >= prm["dup1add"]) & (cc1 * 100 >= t1 * prm["dup1perc"])
            & fam_ok)
    base = cs1 < 6
    emperr = torch.where(base, prm["emperr_snv"], prm["emperr_indel"])
    emperc = torch.where(base, prm["emperc_snv"], prm["emperc_indel"])
    emp = s1 & (t1 >= emperr) & (cc1 * 100 >= t1 * emperc)
    z = torch.zeros_like(t1)
    for c, v in enumerate((
            s1.to(torch.int64), (s1 & (t1 == 1)).to(torch.int64),
            good.to(torch.int64),
            (s1 & (t1 >= prm["dup2add"])
             & (cc1 * 100 >= t1 * prm["dup2perc"])).to(torch.int64),
            torch.where(emp, t1 - cc1, z),
            torch.where(emp, t1 * torch.where(base, 5, 7), z))):
        il[:, c].index_add_(0, idx[s1], v[s1])
    cs2 = usym[bi2.clamp(min=0)]
    cnf2 = acc1[bi2.clamp(min=0)]
    s2 = (gf, gp, cs2 | (gs << 4) | (strand << 5), bv2, t2, cnf2, t1)
    g1 = (gf[good], gp[good], gs[good], cs1[good], cc1[good], t1[good])
    return 0, (il, fbeg, fend, s2, g1)


def _near_half(x):
    f = x - torch.floor(x)
    return (f - 0.5).abs() <= 1e-9 * torch.clamp(x.abs(), min=1.0)


def sweep2_plain(il, s2, st, sizes, prm):
    """Sweep 2 (fam_sweep2, fam_m2, fam_planes) over the s2 rows: (err,
    the seven planes after it, hist [2,P,14,16], m2 rows)."""
    P = sizes["P"]
    g, p, meta, cc2, tt2, cnf, tnf = s2
    cs, stt, strand = meta & 15, (meta >> 4) & 1, (meta >> 5) & 1
    idx = (p * NS + cs) * 2 + strand
    il = il.clone()
    il[:, 6].index_add_(0, idx, torch.ones_like(idx))
    avg = torch.where(tnf == 0, torch.ones_like(tnf),
                      torch.div(cc2, tnf.clamp(min=1), rounding_mode="trunc"))
    if len(avg) and (int(avg.min()) < 0 or int(avg.max()) >= NPOW10):
        return E_AVGBQ, None
    major = _wrap32(il[idx, 5]).to(torch.float64)
    minor = _wrap32(il[idx, 4]).to(torch.float64)
    w = 1.0 / (minor + 1.0)
    pw = torch.as_tensor(POW10)[avg]
    realphred = -INV_LOG10 * torch.log((minor + w) / (major + minor + w / pw))
    x = (2 * cnf - tnf).to(torch.float64) * realphred
    if bool((_near_half(x) | ((stt == 1) & _near_half(realphred))).any()):
        return E_ROUND, None
    indep = torch.round(x).to(torch.int64)
    cap = torch.where(stt == 1,
                      prm["indel_inc"] + torch.round(realphred).to(torch.int64),
                      2 * cc2 - tt2)
    confam = torch.minimum(indep, cap).clamp(min=1)
    ref = torch.as_tensor(np.asarray(st["ref"])).to(torch.int64)
    sscs = torch.as_tensor(np.asarray(st["sscs"])).to(torch.int64)
    rs = ref[p]
    max_qual = sscs[rs * NS + cs] + prm["rescue_add"]
    confam2 = torch.minimum(confam, max_qual)
    d = max_qual - confam2 + 2
    pb = torch.div(d, 4, rounding_mode="floor").clamp(0, 15)
    h = tnf >= prm["dup1add"]
    hist = torch.zeros(2 * P * NS * NBUCKETS, dtype=torch.int64).index_add_(
        0, (((strand * P + p) * NS + cs) * NBUCKETS + pb)[h],
        torch.ones_like(pb)[h])
    mut = torch.where(stt == 0,
                      (rs != cs) & (rs < 4) & (cs < 4)
                      & (confam >= prm["highbq"]),
                      (cs != 6) & (cs != 13))
    ok = (h & (cnf * 100 >= tnf * prm["dup1perc"])).to(torch.int64)
    planes = {nm: _wrap32(il[:, c]).reshape(P, NS, 2)
              for c, nm in enumerate(FAM_PLANES)}
    m2 = (g[mut], p[mut], stt[mut], cs[mut], ok[mut])
    return 0, (planes, _wrap32(hist).reshape(2, P, NS, NBUCKETS), m2)


def _np64(cols):
    return tuple(c.numpy().astype(np.int64) for c in cols)


def _run_plain(ci, sizes, staged):
    prm = dict(ci.prm)
    err, fr = frag_merge_plain(staged, sizes, prm)
    if err:
        return None
    cons, _, pd_planes, mut, win = fr
    err, fm = fam_merge_plain(cons, staged, sizes, prm)
    if err:
        return None
    il, fbeg, fend, s2, g1 = fm
    err, sw = sweep2_plain(il, s2, staged, sizes, prm)
    if err:
        return None
    planes, hist, m2 = sw
    pass_d = tuple(x.numpy() for x in pd_planes) + (_np64(mut), _np64(win))
    return ChainOutput(pass_d=pass_d,
                       planes={k: v.numpy() for k, v in planes.items()},
                       hist=hist.numpy(), fbeg=fbeg.numpy(),
                       fend=fend.numpy(), good=_np64(g1), m2=_np64(m2))


# ---- the kernels -------------------------------------------------------------

_TLS = threading.local()
ALIGN = 256


def layout(sizes):
    """(byte offsets of SLOTS, the arena's bytes)."""
    offs, o = [], 0
    for _, dt, cnt in SLOTS:
        offs.append(o)
        o += -(-cnt(sizes) * np.dtype(dt).itemsize // ALIGN) * ALIGN
    return offs, o


def _worker(device):
    """This thread's stream and grow-only buffers: the device arenas of
    the chain (``dev``) and of pass C (``pc_dev``), pinned host buffers
    for their uploads (``host``, ``pc_host``) and one for the readback
    (``back``)."""
    w = getattr(_TLS, "w", None)
    if w is None or w["device"] != device:
        w = dict(device=device, stream=torch.cuda.Stream(device),
                 dev=torch.empty(0, dtype=torch.uint8, device=device),
                 pc_dev=torch.empty(0, dtype=torch.uint8, device=device),
                 **{k: torch.empty(0, dtype=torch.uint8, pin_memory=True)
                    for k in ("host", "pc_host", "back")})
        _TLS.w = w
    return w


def _grow(t, nbytes, **kw):
    if t.numel() >= nbytes:
        return t
    return torch.empty((int(nbytes * 1.25) // ALIGN + 1) * ALIGN,
                       dtype=torch.uint8, **kw)


def launch(ci, device, sync_each=False, pass_c=None):
    """Stage ``ci`` into the thread's pinned buffer, upload it and launch
    the chain on the thread's stream; returns the launch (a dict: sizes,
    offsets, the arena, the stream, ``pass_c``) with the work queued, or
    None where the region does not fit the kernels.  ``pass_c``: a launch
    of pileup/device_pass_c on this thread's stream, whose ``cols`` give
    the addresses of SHARED: the chain reads them there and uploads the
    rest.  ``sync_each``: synchronise after each kernel (the card test's
    mode)."""
    from ..kernels import build
    n, S = len(ci.pos), len(ci.stream_off) - 1
    sizes = dict(n=n, S=S, R=len(ci.frag_of_read), F=ci.n_frags,
                 NF=ci.n_fams, P=ci.P)
    offs, total = layout(sizes)
    in_bytes = offs[SLOT["bdp"]]
    first = len(SHARED) if pass_c is not None else 0
    lo = offs[first]
    w = _worker(device)
    w["host"] = _grow(w["host"], in_bytes, pin_memory=True)
    w["dev"] = _grow(w["dev"], total, device=device)
    host = w["host"].numpy()
    views = {nm: host[offs[i]:offs[i] + cnt(sizes) * np.dtype(dt).itemsize]
             .view(dt) for i, (nm, dt, cnt) in enumerate(SLOTS[:len(INPUTS)])
             if i >= first}
    if stage(ci, out=views) is None:
        return None
    lib = build.load()
    stream, dev = w["stream"], w["dev"]
    addr = [dev.data_ptr() + o for o in offs]
    if pass_c is not None:
        for nm in SHARED:
            addr[SLOT[nm]] = pass_c["cols"][nm]
    c_addr = (ctypes.c_longlong * len(SLOTS))(*addr)
    c_prm = (ctypes.c_longlong * len(PARAMS))(*params(ci, sizes))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev[lo:in_bytes].copy_(w["host"][lo:in_bytes], non_blocking=True)
        rc = lib.uvc_fc_chain(c_addr, c_prm, INV_LOG10,
                              1 if sync_each else 0, stream.cuda_stream)
    kernels.check(lib, "family chain", rc)
    for k, v in CHAIN_LAUNCHES.items():
        kernels.count(k, v)
    return dict(sizes=sizes, offs=offs, dev=dev, stream=stream,
                device=device, pass_c=pass_c)


def slot(run_, nm, count=None):
    """Slot ``nm`` of a launch's arena as a device tensor of its dtype
    (its first ``count`` entries)."""
    i = SLOT[nm]
    dt = torch.from_numpy(np.zeros(0, SLOTS[i][1])).dtype
    m = SLOTS[i][2](run_["sizes"]) if count is None else count
    nb = m * np.dtype(SLOTS[i][1]).itemsize
    o = run_["offs"][i]
    return run_["dev"][o:o + nb].view(dt)


def row_tables(flat, counts):
    """The tables of a rows slot (``flat``, numpy or torch) by ``counts``:
    ({name: its columns}, the slot's used length)."""
    out, o = {}, 0
    for nm, c, nc in ROW_TABLES:
        m = int(counts[c])
        out[nm] = tuple(flat[o + k * m:o + (k + 1) * m] for k in range(nc))
        o += nc * m
    return out, o


def readback(run_):
    """The chain's arrays of a launch: one copy of the planes and counts
    (and, beside them, the planes of the pass C launch it read, left in
    that launch as ``back``), then one of the rows by their counts, each
    through the thread's pinned buffer into ordinary host memory; None
    where a kernel flagged the region."""
    sizes, offs, dev, stream, pc = (run_[k] for k in (
        "sizes", "offs", "dev", "stream", "pass_c"))
    P = sizes["P"]
    lo, hi = offs[SLOT["bdp"]], offs[SLOT["il"]]
    m_pc = 0 if pc is None else pc["planes"].numel()
    w = _worker(run_["device"])
    with torch.cuda.device(run_["device"]), torch.cuda.stream(stream):
        w["back"] = _grow(w["back"], hi - lo + m_pc, pin_memory=True)
        w["back"][:hi - lo].copy_(dev[lo:hi], non_blocking=True)
        if pc is not None:
            w["back"][hi - lo:hi - lo + m_pc].copy_(pc["planes"],
                                                   non_blocking=True)
        stream.synchronize()
        b = w["back"][:hi - lo].numpy().copy()
        if pc is not None:
            from ..pileup import device_pass_c
            pc["back"] = w["back"][hi - lo:hi - lo + m_pc].numpy().copy()
            if device_pass_c.take(pc, pc["back"]) is None:
                return None     # pass C flagged the region: bg, aDP4 unset

        def view(nm, shape=None):
            i = SLOT[nm]
            dt = np.dtype(SLOTS[i][1])
            o = offs[i] - lo
            a = b[o:o + SLOTS[i][2](sizes) * dt.itemsize].view(dt)
            return a if shape is None else a.reshape(shape)

        counts = view("counts")
        if counts[C_ERR]:
            return None
        m = sum(nc * int(counts[c]) for _, c, nc in ROW_TABLES)
        w["back"] = _grow(w["back"], 4 * m, pin_memory=True)
        r0 = offs[SLOT["rows"]]
        w["back"][:4 * m].copy_(dev[r0:r0 + 4 * m], non_blocking=True)
        stream.synchronize()
        rows, _ = row_tables(w["back"][:4 * m].numpy().view(np.int32), counts)
    t = {nm: tuple(c.astype(np.int64) for c in cols)
         for nm, cols in rows.items()}
    pass_d = (view("bdp", (P, NS, 2)), view("bta", (P, NS, 2)),
              view("btb", (P, NS, 2)), view("hist_d", (P, NS, NBUCKETS)),
              view("vq_bmq", (P, NS)), t["mut"], t["win"])
    planes = {nm: view(sl, (P, NS, 2)) for nm, sl in zip(
        FAM_PLANES, ("cdp12", "cdp21", "cdp2", "cdp3", "cdpm_minor",
                     "cdpm_major", "cdp1"))}
    return ChainOutput(pass_d=pass_d, planes=planes,
                       hist=view("hist_f", (2, P, NS, NBUCKETS)),
                       fbeg=view("fbeg"), fend=view("fend"),
                       good=t["g1"], m2=t["m2"])


def _run_kernels(ci, device, pass_c=None):
    run_ = launch(ci, device, pass_c=pass_c)
    return None if run_ is None else readback(run_)


# ---- the host tail of the family engine ------------------------------------

def fq_result(out, frag_gap_info, famgrp, ref_syms, sscs_table, thres, baq,
              baq2, batch, P, cfg):
    """engine_fq.run_fq's statics path after its native chain
    (engine_fq._run_fq_statics from its ``c2info`` on, line for line): c2
    bias, phase signatures, family indels and the iid scan, over the
    chain's arrays."""
    from ..pileup import consensus as cns
    from .engine_fq import (C2_NAMES, FQResult, _c2_bias_sparse,
                            _family_indels, _iid_scan,
                            _phase_signatures_sparse)
    fam_of_frag = famgrp.fam_of_frag
    cdp1, cdp12, cdp2, cdp3, cdp21, cdpM, cdpm = (
        out.planes[nm] for nm in ("cdp1", "cdp12", "cdp2", "cdp3", "cdp21",
                                  "cdpM", "cdpm"))
    cdpD = np.zeros((P, NS, 2), dtype=np.int32)
    rescue_add = 0 if cfg.vcf_tumor_fname in (".", "") else 4
    hist = out.hist
    (gg, gp, gst, gs, gcnt, gtot), m2, fbeg, fend = (out.good, out.m2,
                                                     out.fbeg, out.fend)
    c2info = {nm: np.zeros((P, NS), dtype=np.int64) for nm in C2_NAMES}
    if len(gg):
        _c2_bias_sparse(c2info, gg, gp, gst, gs, fbeg, fend, thres, baq,
                        baq2, P, cfg)
    ind = (gs >= 7) & (gs <= 12)
    good_set = set(zip(gg[ind].tolist(), gp[ind].tolist(),
                       gs[ind].tolist()))
    mutforms_fq, mutforms_f2q = _phase_signatures_sparse(
        m2, famgrp.fam_strand)

    # duplex tiers are gated off on this path (no 0x2 dflags; see run_fq)
    ddp1 = np.zeros((P, NS), dtype=np.int64)
    ddp2 = np.zeros((P, NS), dtype=np.int64)
    fam_indel = _family_indels(frag_gap_info, None, fam_of_frag, P,
                               famgrp.frag_of_read, batch,
                               famgrp.fam_strand, good_set, frozenset(),
                               famgrp.duplex_pair, frozenset())

    vq_cIAQ = np.zeros((P, NS, 2), dtype=np.int64)
    vq_cIAD = np.zeros((P, NS, 2), dtype=np.int64)
    vq_cIDQ = np.zeros((P, NS, 2), dtype=np.int64)
    refmat = np.broadcast_to(ref_syms[:, None], (P, NS))
    symmat = np.broadcast_to(np.arange(NS)[None, :], (P, NS))
    mq_all = sscs_table[refmat, symmat] + rescue_add
    tot_types = cns.sum_by_symboltype(
        np.ascontiguousarray(cdp1.transpose(2, 0, 1)))
    for strand in (0, 1):
        q, ad, bq = _iid_scan(mq_all, 4, hist[strand], tot_types[strand])
        vq_cIAQ[:, :, strand] = q
        vq_cIAD[:, :, strand] = ad
        vq_cIDQ[:, :, strand] = bq

    return FQResult(cdp1=cdp1, cdp12=cdp12, cdp2=cdp2, cdp3=cdp3,
                    cdp21=cdp21, cdpM=cdpM, cdpm=cdpm, cdpD=cdpD,
                    ddp1=ddp1, ddp2=ddp2, c2info=c2info,
                    vq_cIAQ=vq_cIAQ, vq_cIAD=vq_cIAD, vq_cIDQ=vq_cIDQ,
                    fam_indel=fam_indel, mutforms_fq=mutforms_fq,
                    mutforms_f2q=mutforms_f2q)
