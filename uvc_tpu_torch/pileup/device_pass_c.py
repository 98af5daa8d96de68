"""Pass C of host prepare on the card.

The host route (engine_bq.pass_c_scatter) runs pass C, dealwith_segbias's
per-event scatter into the segment counters, as one native call
(ops/native_rowpile.pass_c_native, native/rowpile.cpp pass_c_kernel).
This module gives it a device route: one launcher of
kernels/csrc/pass_c.cu (``pc_scatter``, one thread an event, and
``pc_adp4``), one upload a region on the calling worker thread's own CUDA
stream (family/device_chain's), into an arena of that thread.  The arena
keeps what the family chain reads after it: the event columns, bg and
aDP4 (device_chain.launch's ``pass_c``), so the chain uploads none of
them.  The planes come back in the chain's readback (device_chain.readback
copies them beside its own), or in one copy of their own where the chain
takes the host route; both go through the thread's grow-only pinned buffer
into ordinary host memory.  ``result`` returns them as pass_c_scatter
does: the int32 planes as views of a [P, 14, 34] array, the int64 ones
([P, 14] each: aLBL, aRBL, aLIT, aRIT, bg), a1 and a2.

Beside the kernel is its plain PyTorch version (``scatter_plain``):
``route`` takes it on a CPU device and the kernel on a card.  Where a
column would not survive its narrowing (``stage``), or where the kernel
finds an event outside the region's planes or reads, the host's pass runs,
exactly as before.

The route is the family chain's: where device_chain.route_device gives a
device and the events carry their stream offsets; duplex-flagged regions
take it too (pass C reads no family).  Its test hook is the chain's
``ROUTE_TYPES``.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..constants import MAX_INSERT_SIZE, NUM_SYMBOLS
from ..family import device_chain
from ..ops.native_rowpile import BIG_PLANES, N_RF, N_TH, PLANES
from . import engine_bq

NS = NUM_SYMBOLS
NPL, NBIG = len(PLANES), len(BIG_PLANES)
E_EVENTS = 1                            # csrc/pass_c.cu Err
F_GAP, F_INS, F_FAR_INDEL = 1, 2, 4     # csrc/pass_c.cu Flag
# the thresholds' columns, in native/rowpile.cpp's order (TH_*)
THRES = ("aLPxT", "aRPxT", "aLP1t", "aLP2t", "aRP1t", "aRP2t", "aLI1t",
         "aLI1T", "aLI2t", "aLI2T", "aRI1t", "aRI1T", "aRI2t", "aRI2T")

# the kernel arena's slots (csrc/pass_c.cu Slot, in order): name, dtype,
# and the element count as a function of the region's sizes
_N = lambda d: d["n"]                                   # noqa: E731
SLOTS = (
    ("pos", np.int32, _N), ("sym", np.int8, _N), ("val", np.int32, _N),
    ("read", np.int32, _N), ("ilen", np.int32, _N),
    ("flags", np.uint8, _N),
    ("reads", np.int32, lambda d: d["R"] * N_RF),
    ("bm", np.int32, lambda d: d["R"] * 6),
    ("thres", np.int32, lambda d: d["P"] * N_TH),
    ("baq", np.int32, lambda d: d["P"]), ("baq2", np.int32, lambda d: d["P"]),
    # zeroed by the launcher; out .. err read back in one copy
    ("out", np.int32, lambda d: d["P"] * NS * NPL),
    ("big", np.int64, lambda d: NBIG * d["P"] * NS),
    ("err", np.int32, lambda d: 1),
    # the family chain's aDP4, kept on the card
    ("adp4", np.int64, lambda d: d["P"] * NS),
)
SLOT = {nm: i for i, (nm, _, _) in enumerate(SLOTS)}
INPUTS = tuple(nm for nm, _, _ in SLOTS[:SLOT["out"]])
PARAMS = ("n", "P", "R", "interfering_indel", "primerlen2",
          "is_high_readlen", "baq_mul_1024", "highbaq", "highbq", "pfbq1",
          "pfbq2", "bias_baq1", "bias_baq2", "nobias_indel_maxlen",
          "max_insert", "norm_primer")
# kernels of one region's pass C, by launches (kernels.LAUNCHES)
PASS_C_LAUNCHES = {"pass_c": 2}


# ---- the input -------------------------------------------------------------

def reads_table(table, off, cfg, dflag):
    """The per-read columns pass_c_native hands the kernel ([R, N_RF]
    int64, native/rowpile.cpp's RF_* order)."""
    r = table.reads
    reads = np.zeros((len(r.pos), N_RF), dtype=np.int64)
    for c, v in enumerate((
            r.pos - off, r.rend - off, r.isrc, r.strand, r.isize,
            r.is_paired, r.flag, r.mapq, r.clip_cnt, r.frag_pos_L - off,
            r.frag_pos_R - off, r.xm1500,
            ((dflag & 0x4) != 0) | ((cfg.primerlen > 0)
                                    and not (0x2 & cfg.primer_flag)),
            (dflag & 0x1) != 0)):
        reads[:, c] = v
    return reads


def params(sizes, cfg):
    """PARAMS' values: the sizes, then pass_c_native's cfg vector."""
    return [int(v) for v in (
        sizes["n"], sizes["P"], sizes["R"], cfg.bias_thres_interfering_indel,
        cfg.primerlen2,
        cfg.central_readlen >= cfg.microadjust_median_readlen_thres,
        cfg.microadjust_BAQ_per_base_x1024, cfg.bias_thres_highBAQ,
        cfg.bias_thres_highBQ, cfg.bias_thres_PFBQ1, cfg.bias_thres_PFBQ2,
        cfg.bias_thres_BAQ1, cfg.bias_thres_BAQ2,
        cfg.microadjust_nobias_pos_indel_maxlen, MAX_INSERT_SIZE, 0)]


def _bit(mask, bit):
    return np.asarray(mask, dtype=bool).view(np.uint8) * np.uint8(bit)


def stage(allev, table, baq, baq2, thres, off, P, cfg, dflag, out=None):
    """Pass C's inputs in the kernel's types, as (sizes, {slot: array}):
    the event columns narrowed to int32 (sym to int8), the flags byte
    (is_gap, cigar_op == 1, dist >= bias_thres_interfering_indel), the
    reads table, bm1500 (zeros where the events have none), the
    thresholds, baq and baq2 as int32.  ``out`` ({slot: array view})
    receives them in place (the pinned staging buffer); else they are new
    arrays.  None where the region does not fit the kernel: no event, a
    column that int32 would wrap, an event column below 0."""
    e = allev
    n, R = len(e.pos), len(table.reads.pos)
    if not (0 < n < 2**31 - 1 and 0 < R < 2**31 and 0 < P < 2**25
            and len(baq) >= P and len(baq2) >= P and len(dflag) == R):
        return None
    if any(np.bitwise_or.reduce(c) >> 31
           for c in (e.pos, e.val, e.read, e.indel_len)):
        return None
    bm = e.bm1500 if getattr(e, "bm1500", None) is not None \
        else np.zeros((R, 6), dtype=np.int64)
    small = dict(reads=reads_table(table, off, cfg, dflag), bm=bm,
                 thres=np.stack([getattr(thres, nm)[:P] for nm in THRES],
                                axis=1),
                 baq=baq[:P], baq2=baq2[:P])
    if any(v.size and (v.min() < -2**31 or v.max() >= 2**31)
           for v in small.values()):
        return None
    flags = (_bit(e.is_gap, F_GAP) | _bit(e.cigar_op == 1, F_INS)
             | _bit(e.dist >= cfg.bias_thres_interfering_indel, F_FAR_INDEL))
    src = dict(small, pos=e.pos, sym=e.sym, val=e.val, read=e.read,
               ilen=e.indel_len, flags=flags)
    sizes = dict(n=n, R=R, P=P)
    staged = {}
    for nm, dt, cnt in SLOTS[:len(INPUTS)]:
        dst = out[nm] if out is not None else np.empty(cnt(sizes), dt)
        np.copyto(dst, src[nm].reshape(-1), casting="unsafe")
        staged[nm] = dst
    return sizes, staged


# ---- the plain version -----------------------------------------------------

def _wrap32(t):
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


def _tdiv(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def scatter_plain(sizes, st, prm):
    """pc_scatter and pc_adp4 on the staged inputs, in torch int64 with
    index_add_ over pos * 14 + sym: (err, (out [P, 14, 34] int32, big
    [5, P, 14] int64, adp4 [P * 14] int64))."""
    T = {k: torch.as_tensor(np.asarray(v)).to(torch.int64)
         for k, v in st.items()}
    p = dict(zip(PARAMS, prm))
    P, R = sizes["P"], sizes["R"]
    pos, sym, bq, rd, il, fl = (T[k] for k in ("pos", "sym", "val", "read",
                                               "ilen", "flags"))
    if not bool(((pos >= 0) & (pos < P) & (sym >= 0) & (sym < NS)
                 & (rd >= 0) & (rd < R)).all()):
        return E_EVENTS, None
    reads = T["reads"].reshape(R, N_RF)
    th = T["thres"].reshape(P, N_TH)
    baq, baq2 = T["baq"], T["baq2"]

    def rc(c):
        return reads[:, c][rd]

    def tc(nm):
        return th[:, THRES.index(nm)][pos]

    idx = pos * NS + sym
    acc = torch.zeros((NPL, P * NS), dtype=torch.int64)
    big = torch.zeros((NBIG, P * NS), dtype=torch.int64)

    def add(nm, v):
        v = v.to(torch.int64)
        if nm in BIG_PLANES:
            big[BIG_PLANES.index(nm)].index_add_(0, idx, v)
        else:
            acc[PLANES.index(nm)].index_add_(0, idx, v)

    def where(m, a, b=0):
        return torch.where(m, torch.as_tensor(a, dtype=torch.int64),
                           torch.as_tensor(b, dtype=torch.int64))

    isgap, ins, far_indel = ((fl & f) != 0 for f in (F_GAP, F_INS,
                                                     F_FAR_INDEL))
    isrc, strand = rc(2) != 0, rc(3) != 0
    isize, paired, flag = rc(4), rc(5) != 0, rc(6)
    add("bg", bq)
    add("a1BQr", where(isrc, bq))
    add("a1BQf", where(~isrc, bq))
    sq = _tdiv(bq * bq, 32)
    add("a2BQr", where(isrc, sq))
    add("a2BQf", where(~isrc, sq))
    add("aMQs", rc(7))
    for nm, s, c in (("aDPff", 0, 0), ("aDPfr", 0, 1), ("aDPrf", 1, 0),
                     ("aDPrr", 1, 1)):
        add(nm, (strand == bool(s)) & (isrc == bool(c)))
    seg_l = pos - rc(0) + 1
    seg_r = rc(1) - pos
    T_ind = p["interfering_indel"]
    add("aP3", far_indel & (seg_l >= T_ind) & (seg_r >= T_ind))
    add("aNC", rc(8) == 0)
    MAXI = p["max_insert"]
    has_is = isize != 0
    frag_l2 = where(has_is, torch.clamp(pos - rc(9) + 1, max=MAXI), MAXI)
    frag_r2 = where(has_is, torch.clamp(rc(10) - pos, max=MAXI), MAXI)
    add("aLIT", where(isrc & has_is, frag_l2))
    add("aRIT", where(~isrc & has_is, frag_r2))
    p_beg = torch.clamp(rc(0), 0, P - 1)
    p_end = torch.clamp(rc(1) - 1, 0, P - 1)
    seg_l_baq = baq[pos] - baq[p_beg] + 1
    seg_r_baq = baq[p_end] - baq[pos] + 1
    seg_r_baq = where(isgap, torch.minimum(seg_r_baq,
                                           baq2[p_end] - baq2[pos] + 7),
                      seg_r_baq)
    if not p["is_high_readlen"]:
        mul = p["baq_mul_1024"]
        seg_l_baq = torch.maximum(seg_l_baq, _tdiv(seg_l * mul, 1024))
        seg_r_baq = torch.maximum(seg_r_baq, _tdiv(seg_r * mul, 1024))
    lpxt, rpxt = tc("aLPxT"), tc("aRPxT")
    const_LPxT = where(isgap, lpxt, torch.minimum(lpxt, rpxt))
    ins_relax = where(ins, torch.clamp(il - p["nobias_indel_maxlen"], min=0))
    is_far = (seg_l + ins_relax >= const_LPxT) & (seg_r >= rpxt)
    thr_baq = p["highbaq"] + where(isgap, 0, 3)
    is_unaff = (seg_l_baq >= thr_baq) & (seg_r_baq >= thr_baq)
    is_amp, is_umi = rc(12) != 0, rc(13) != 0
    min_d2i = where(paired, torch.minimum(frag_l2, frag_r2),
                    where(isrc, seg_r, seg_l))
    add("aP1", is_far & is_unaff & ((min_d2i > p["primerlen2"]) | ~is_amp))
    add("aP2", is_umi | ~is_amp)
    for nm, t in (("aPF1", p["pfbq1"]), ("aPF2", p["pfbq2"])):
        pf = where(bq < t, _tdiv(100 * bq * bq, max(t * t, 1)), 100)
        add(nm, where(isgap, torch.clamp(pf, max=100), pf))
    ng = ~isgap
    xm = rc(11)
    add("a2XM2", where(ng, where(xm > 20, _tdiv(
        torch.full_like(xm, 40000), torch.clamp(xm * xm, min=1)), 100)))
    bm = T["bm"].reshape(R, 6)[rd, torch.clamp(sym, max=5)]
    bm = where(sym < 6, bm)
    add("a2BM2", where(ng, where(bm > 20, _tdiv(
        torch.full_like(bm, 40000), torch.clamp(bm * bm, min=1)), 100)))
    high = bq >= p["highbq"]
    gate = torch.where(isgap, far_indel, high)
    tier2 = isgap | high
    gp, gu = gate & is_far, gate & is_unaff
    add("aLP1", gp & (seg_l + il >= tc("aLP1t")))
    add("aLP2", gp & tier2 & (seg_l + il >= tc("aLP2t")))
    add("aRP1", gp & (seg_r >= tc("aRP1t")))
    add("aRP2", gp & tier2 & (seg_r >= tc("aRP2t")))
    add("aLPL", where(gp, seg_l))
    add("aRPL", where(gp, seg_r))
    add("aLB1", gu & (seg_l_baq >= p["bias_baq1"]))
    add("aLB2", gu & tier2 & (seg_l_baq >= p["bias_baq2"]))
    add("aRB1", gu & (seg_r_baq >= p["bias_baq1"]))
    add("aRB2", gu & tier2 & (seg_r_baq >= p["bias_baq2"]))
    add("aLBL", where(gu, seg_l_baq))
    add("aRBL", where(gu, seg_r_baq))
    add("aBQ2", gate)
    mate_ok = ((flag & 0x8) == 0) | ((flag & 0x1) == 0)
    is_norm = has_is | ~paired
    pos_good = ~is_amp | (is_far & is_unaff)
    for side, m, d2, nonb in (
            ("L", isrc, frag_l2, mate_ok & (seg_l > seg_r)),
            ("R", ~isrc, frag_r2, mate_ok & (seg_l < seg_r))):
        norm = is_norm | (isgap & nonb)
        add(f"a{side}I1", m & (d2 >= tc(f"a{side}I1t"))
            & ((d2 <= tc(f"a{side}I1T")) | isgap) & norm)
        add(f"a{side}I2", m & (d2 >= tc(f"a{side}I2t"))
            & ((d2 <= tc(f"a{side}I2T")) | isgap) & norm & pos_good)
    add("aLIr", isrc & pos_good)
    add("aRIf", ~isrc & pos_good)
    out = _wrap32(acc).T.contiguous().reshape(P, NS, NPL)
    quad = sum(acc[PLANES.index(nm)] for nm in ("aDPff", "aDPfr", "aDPrf",
                                                "aDPrr"))
    adp4 = _wrap32(quad).to(torch.int64)
    return 0, (out, big.reshape(NBIG, P, NS), adp4)


def host_planes(out, big, P):
    """(info, bg, a1, a2) from the planes ([P, 14, 34] int32, [5, P, 14]
    int64), as engine_bq.pass_c_scatter builds them from the native
    pass's."""
    planes = {nm: out[:, :, i] for i, nm in enumerate(PLANES)}
    planes.update({nm: big[i] for i, nm in enumerate(BIG_PLANES)})
    info = engine_bq.SegInfo.__new__(engine_bq.SegInfo)
    info.P = P
    for nm in engine_bq.SegInfo.names:
        setattr(info, nm, planes[nm])
    bg = planes["bg"]
    a1 = np.stack([planes["a1BQf"], planes["a1BQr"]], axis=-1)
    a2 = np.stack([planes["a2BQf"], planes["a2BQr"]], axis=-1)
    return info, bg, a1, a2


# ---- the kernel ------------------------------------------------------------

def layout(sizes):
    """(byte offsets of SLOTS, the arena's bytes)."""
    offs, o = [], 0
    for _, dt, cnt in SLOTS:
        offs.append(o)
        o += -(-cnt(sizes) * np.dtype(dt).itemsize
               // device_chain.ALIGN) * device_chain.ALIGN
    return offs, o


def launch(allev, table, baq, baq2, thres, off, P, cfg, dflag, device,
           sync_each=False):
    """Stage pass C's inputs into the thread's pinned buffer, upload them
    and launch the kernels on the thread's stream; returns the launch (a
    dict: sizes, offsets, the arena, the stream, ``cols``: the addresses of
    the family chain's inputs it holds, ``planes``: the bytes to read
    back, ``err_at``: the error word's byte in them) with the work queued,
    or None where the region does not fit the kernel.  ``sync_each``:
    synchronise after each kernel (the card test's mode)."""
    from ..kernels import build
    sizes = dict(n=len(allev.pos), R=len(table.reads.pos), P=P)
    offs, total = layout(sizes)
    in_bytes = offs[SLOT["out"]]
    w = device_chain._worker(device)
    w["pc_host"] = device_chain._grow(w["pc_host"], in_bytes, pin_memory=True)
    w["pc_dev"] = device_chain._grow(w["pc_dev"], total, device=device)
    host = w["pc_host"].numpy()
    views = {nm: host[offs[i]:offs[i] + cnt(sizes) * np.dtype(dt).itemsize]
             .view(dt) for i, (nm, dt, cnt) in enumerate(SLOTS[:len(INPUTS)])}
    if stage(allev, table, baq, baq2, thres, off, P, cfg, dflag,
             out=views) is None:
        return None
    lib = build.load()
    stream, dev = w["stream"], w["pc_dev"]
    addr = [dev.data_ptr() + o for o in offs]
    c_addr = (ctypes.c_longlong * len(SLOTS))(*addr)
    c_prm = (ctypes.c_longlong * len(PARAMS))(*params(sizes, cfg))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev[:in_bytes].copy_(w["pc_host"][:in_bytes], non_blocking=True)
        rc = lib.uvc_pc_scatter(c_addr, c_prm, 1 if sync_each else 0,
                                stream.cuda_stream)
    kernels.check(lib, "pass C", rc)
    for k, v in PASS_C_LAUNCHES.items():
        kernels.count(k, v)
    lo, hi = offs[SLOT["out"]], offs[SLOT["adp4"]]
    big = addr[SLOT["big"]] + (NBIG - 1) * P * NS * 8
    return dict(sizes=sizes, offs=offs, dev=dev, stream=stream,
                device=device, planes=dev[lo:hi],
                err_at=offs[SLOT["err"]] - lo,
                cols=dict(pos=addr[SLOT["pos"]], sym=addr[SLOT["sym"]],
                          val=addr[SLOT["val"]], read=addr[SLOT["read"]],
                          bg=big, adp4=addr[SLOT["adp4"]]))


def readback(run_):
    """The planes' bytes of a launch: one copy through the thread's pinned
    buffer into ordinary host memory."""
    w = device_chain._worker(run_["device"])
    m = run_["planes"].numel()
    with torch.cuda.device(run_["device"]), torch.cuda.stream(run_["stream"]):
        w["back"] = device_chain._grow(w["back"], m, pin_memory=True)
        w["back"][:m].copy_(run_["planes"], non_blocking=True)
        run_["stream"].synchronize()
        return w["back"][:m].numpy().copy()


def take(run_, b):
    """(out, big) as views of the read-back bytes ``b``, or None where the
    kernel flagged the region."""
    if b[run_["err_at"]:run_["err_at"] + 4].view(np.int32)[0]:
        return None
    offs, P = run_["offs"], run_["sizes"]["P"]
    lo = offs[SLOT["out"]]

    def view(nm, shape):
        i = SLOT[nm]
        dt = np.dtype(SLOTS[i][1])
        o = offs[i] - lo
        return b[o:o + SLOTS[i][2](run_["sizes"]) * dt.itemsize].view(
            dt).reshape(shape)

    return view("out", (P, NS, NPL)), view("big", (NBIG, P, NS))


# ---- the route -------------------------------------------------------------

@dataclass
class PassC:
    """Pass C of one region: the host pass's arguments, the route, the
    planes once on the host ((info, bg, a1, a2)), and the card's launch
    while they are still there."""
    args: tuple
    route: str = "host"
    planes: tuple = None
    run: dict = None

    @property
    def info(self):
        return None if self.planes is None else self.planes[0]

    @property
    def bg(self):
        return None if self.planes is None else self.planes[1]


def route(allev, table, baq, baq2, thres, off, P, cfg, dflag):
    """Pass C of one region on the family chain's device (plain version on
    a CPU device, the kernels on a card, the planes then still there),
    where the events carry their stream offsets and fit the kernel; else
    the host's pass_c_scatter."""
    args = (allev, table, baq, baq2, thres, off, P, cfg, dflag)
    device = device_chain.route_device(cfg)
    if device is not None and getattr(allev, "stream_off", None) is not None:
        if device.type == "cpu":
            st = stage(*args)
            if st is not None:
                err, got = scatter_plain(*st, params(st[0], cfg))
                if not err:
                    out, big, _ = got
                    return PassC(args, "device", host_planes(
                        out.numpy(), big.numpy(), P))
        else:
            run_ = launch(*args, device)
            if run_ is not None:
                return PassC(args, "device", run=run_)
    return PassC(args, "host", engine_bq.pass_c_scatter(*args))


def result(pc):
    """(info, bg, a1, a2) of ``pc``, as engine_bq.pass_c_scatter returns
    them: from the read-back bytes (the family chain's readback may have
    fetched them; else one copy now), or the host's pass where the kernel
    flagged the region (the route then reads ``host``)."""
    if pc.planes is None:
        run_, pc.run = pc.run, None
        b = run_.get("back")
        got = take(run_, readback(run_) if b is None else b)
        if got is None:
            pc.route = "host"
            pc.planes = engine_bq.pass_c_scatter(*pc.args)
        else:
            pc.planes = host_planes(*got, run_["sizes"]["P"])
    return pc.planes
