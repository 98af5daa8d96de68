// Pass C of host prepare on the card: dealwith_segbias's per-event scatter
// into the segment counters (reference main.hpp:1360-1595), one thread an
// event.
//
// Replaces no TPU kernel.  The JAX package runs pass C as host C++
// (native/rowpile.cpp pass_c_kernel, behind engine_bq.pass_c_scatter); the
// port's host route runs the same library.  This file gives pass C a device
// route (pileup/device_pass_c.py, which also holds the plain PyTorch
// version) that reproduces pass_c_kernel term for term: every term is an
// integer, computed in int64 where the host computes in int64, with C's
// truncating `/` on both sides.  The terms go in by atomics: integer sums,
// so their order does not matter, and the int32 planes wrap as the host's
// do.  An add of 0 is skipped.
//
// Memory: one arena a worker thread; the wrapper lays out the slots below
// (Slot, in this order) and passes their addresses.  Inputs are uploaded in
// one copy: the event columns narrowed to int32 (sym to int8) after a
// range check, and one flags byte an event (is_gap, cigar_op == 1, and
// dist >= bias_thres_interfering_indel: pass_c_kernel reads dist only
// through that comparison), the reads table [R, N_RF] and bm1500 [R, 6],
// the thresholds [P, N_TH], baq and baq2, all int32.  Outputs: the int32
// planes interleaved per (pos, sym) as the host's [P, 14, 34] buffer, the
// five int64 planes one after another ([5, P, 14]: bg last, the family
// chain's input as it is), the error word, and aDP4 (the four quadrant
// depths' sum, the family chain's other input), which stays on the card.
// The chain (family/device_chain.py) reads the event columns, bg and aDP4
// where this arena holds them.
//
// Kernels, in launch order (uvc_pc_scatter):
//   pc_scatter   one thread an event: its read's row and its position's
//                thresholds, then ~35 terms into the planes at
//                (pos * 14 + sym); an event outside the region's planes or
//                reads sets E_EVENTS and the wrapper runs the host route
//   pc_adp4      one thread a (pos, sym): aDP4 as int32 sums, widened
//
// Bound: memory traffic.  Each event's 18 bytes and each read's row read
// once, the planes written once.  The atomics land in L2: a warp's events
// are neighbouring positions of one read, so a warp's adds to one plane
// fall on distinct addresses, and no two threads of a warp contend;
// chip_smoke.py reports the share reached.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NS = 14;
constexpr int T = 256;

// the arena's slots, in the order of pileup/device_pass_c.py SLOTS
enum Slot {
    S_POS, S_SYM, S_VAL, S_READ, S_ILEN, S_FLAGS, S_READS, S_BM, S_THRES,
    S_BAQ, S_BAQ2, S_OUT, S_BIG, S_ERR, S_ADP4,
    N_SLOTS
};

// scalar parameters, in the order of pileup/device_pass_c.py PARAMS: the
// sizes, then native_rowpile.pass_c_native's cfg vector
enum Param {
    P_N, P_P, P_R, P_INTERFERING_INDEL, P_PRIMERLEN2, P_IS_HIGH_READLEN,
    P_BAQ_MUL_1024, P_HIGHBAQ, P_HIGHBQ, P_PFBQ1, P_PFBQ2, P_BIAS_BAQ1,
    P_BIAS_BAQ2, P_NOBIAS_INDEL_MAXLEN, P_MAX_INSERT, P_NORM_PRIMER,
    N_PARAMS
};

// the flags byte of an event
enum Flag { F_GAP = 1, F_INS = 2, F_FAR_INDEL = 4 };

// error bits: each sends the region to the host route
enum Err { E_EVENTS = 1 };

// the int32 planes, in the order of native/rowpile.cpp (O_*)
enum Plane {
    O_a2XM2, O_a2BM2, O_aPF1, O_aPF2, O_aBQ2, O_aMQs, O_aP1, O_aP2, O_aP3,
    O_aNC, O_aDPff, O_aDPfr, O_aDPrf, O_aDPrr, O_aLP1, O_aLP2, O_aLPL,
    O_aRP1, O_aRP2, O_aRPL, O_aLB1, O_aLB2, O_aRB1, O_aRB2,
    O_aLI1, O_aLI2, O_aRI1, O_aRI2, O_aRIf, O_aLIr,
    O_a1BQf, O_a1BQr, O_a2BQf, O_a2BQr,
    N_PLANES
};
enum Big { B_aLBL, B_aRBL, B_aLIT, B_aRIT, B_bg, N_BIG };

// the reads table's columns and the thresholds', as native/rowpile.cpp's
enum {
    RF_pos, RF_rend, RF_isrc, RF_strand, RF_isize, RF_paired, RF_flag,
    RF_mapq, RF_clipcnt, RF_fragL, RF_fragR, RF_xm1500, RF_amplicon, RF_umi,
    N_RF
};
enum {
    TH_aLPxT, TH_aRPxT, TH_aLP1t, TH_aLP2t, TH_aRP1t, TH_aRP2t,
    TH_aLI1t, TH_aLI1T, TH_aLI2t, TH_aLI2T,
    TH_aRI1t, TH_aRI1T, TH_aRI2t, TH_aRI2T,
    N_TH
};

struct Args {
    const int* pos; const signed char* sym; const int* val; const int* read;
    const int* ilen; const unsigned char* flags; const int* reads;
    const int* bm; const int* thres; const int* baq; const int* baq2;
    int* out; long long* big; int* err; long long* adp4;
    long long n;
    int P, R;
    long long interfering_indel, primerlen2, is_high_readlen, baq_mul_1024;
    long long highbaq, highbq, pfbq1, pfbq2, bias_baq1, bias_baq2;
    long long nobias_indel_maxlen, max_insert;
};

__device__ __forceinline__ long long lmin(long long x, long long y) {
    return x < y ? x : y;
}
__device__ __forceinline__ long long lmax(long long x, long long y) {
    return x > y ? x : y;
}
__device__ __forceinline__ long long lclip(long long v, long long lo,
                                           long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// o[k] += v as the host's int32 counter takes an int64 term: modulo 2^32
__device__ __forceinline__ void add(int* o, long long v) {
    if (v) atomicAdd(o, static_cast<int>(v));
}
__device__ __forceinline__ void add_big(long long* o, long long v) {
    if (v) atomicAdd(reinterpret_cast<unsigned long long*>(o),
                     static_cast<unsigned long long>(v));
}

__global__ void __launch_bounds__(T) pc_scatter(Args a) {
    const long long e = (long long)blockIdx.x * T + threadIdx.x;
    if (e >= a.n) return;
    const long long pos = a.pos[e];
    const int sym = a.sym[e];
    const int rd = a.read[e];
    if (pos < 0 || pos >= a.P || sym < 0 || sym >= NS || rd < 0
        || rd >= a.R) {
        atomicOr(a.err, E_EVENTS);
        return;
    }
    const long long bq = a.val[e];
    const long long indel_len = a.ilen[e];
    const unsigned fl = a.flags[e];
    const bool isgap = fl & F_GAP;
    const int* r = a.reads + (long long)rd * N_RF;
    const int* th = a.thres + pos * N_TH;
    const long long PN = (long long)a.P * NS;
    const long long idx = pos * NS + sym;
    int* o = a.out + idx * N_PLANES;
    long long* ob = a.big + idx;            // big plane k at ob[k * PN]

    const bool isrc = r[RF_isrc] != 0;
    const bool strand = r[RF_strand] != 0;
    const long long isize = r[RF_isize];
    const bool paired = r[RF_paired] != 0;
    const long long flag = r[RF_flag];

    add_big(ob + B_bg * PN, bq);
    add(o + (isrc ? O_a1BQr : O_a1BQf), bq);
    add(o + (isrc ? O_a2BQr : O_a2BQf), bq * bq / 32);
    add(o + O_aMQs, r[RF_mapq]);
    add(o + (strand ? (isrc ? O_aDPrr : O_aDPrf)
                    : (isrc ? O_aDPfr : O_aDPff)), 1);

    const long long seg_l = pos - r[RF_pos] + 1;
    const long long seg_r = r[RF_rend] - pos;
    // min(dist, seg_l, seg_r) >= T, dist >= T in the flags byte
    add(o + O_aP3, (fl & F_FAR_INDEL) && seg_l >= a.interfering_indel
                   && seg_r >= a.interfering_indel);
    add(o + O_aNC, r[RF_clipcnt] == 0);

    const long long MAXI = a.max_insert;
    const bool has_is = isize != 0;
    const long long frag_l2 = has_is ? lmin(pos - r[RF_fragL] + 1, MAXI)
                                     : MAXI;
    const long long frag_r2 = has_is ? lmin(r[RF_fragR] - pos, MAXI) : MAXI;
    add_big(ob + B_aLIT * PN, (isrc && has_is) ? frag_l2 : 0);
    add_big(ob + B_aRIT * PN, (!isrc && has_is) ? frag_r2 : 0);

    const long long p_beg = lclip(r[RF_pos], 0, a.P - 1);
    const long long p_end = lclip((long long)r[RF_rend] - 1, 0, a.P - 1);
    const long long seg_l_baq1 = (long long)a.baq[pos] - a.baq[p_beg] + 1;
    const long long seg_r_baq_ = (long long)a.baq[p_end] - a.baq[pos] + 1;
    const long long seg_r_baq1 = isgap
        ? lmin(seg_r_baq_, (long long)a.baq2[p_end] - a.baq2[pos] + 7)
        : seg_r_baq_;
    long long seg_l_baq = seg_l_baq1, seg_r_baq = seg_r_baq1;
    if (!a.is_high_readlen) {
        seg_l_baq = lmax(seg_l_baq1, seg_l * a.baq_mul_1024 / 1024);
        seg_r_baq = lmax(seg_r_baq1, seg_r * a.baq_mul_1024 / 1024);
    }
    const long long lpxt = th[TH_aLPxT], rpxt = th[TH_aRPxT];
    const long long const_LPxT = isgap ? lpxt : lmin(lpxt, rpxt);
    const long long ins_relax = (fl & F_INS)
        ? lmax(indel_len - a.nobias_indel_maxlen, 0) : 0;
    const bool is_far = seg_l + ins_relax >= const_LPxT && seg_r >= rpxt;
    const long long thr_baq = a.highbaq + (isgap ? 0 : 3);
    const bool is_unaff = seg_l_baq >= thr_baq && seg_r_baq >= thr_baq;

    const bool is_amp = r[RF_amplicon] != 0;
    const bool is_umi = r[RF_umi] != 0;
    const long long min_d2i = paired ? lmin(frag_l2, frag_r2)
                                     : (isrc ? seg_r : seg_l);
    add(o + O_aP1, is_far && is_unaff
                   && (min_d2i > a.primerlen2 || !is_amp));
    add(o + O_aP2, is_umi || !is_amp);

    const long long t1 = a.pfbq1, t2 = a.pfbq2;
    const long long pf1 = bq < t1 ? 100 * bq * bq / (t1 * t1) : 100;
    const long long pf2 = bq < t2 ? 100 * bq * bq / (t2 * t2) : 100;
    add(o + O_aPF1, isgap ? lmin(100, pf1) : pf1);
    add(o + O_aPF2, isgap ? lmin(100, pf2) : pf2);
    if (!isgap) {
        const long long xm = r[RF_xm1500];
        add(o + O_a2XM2, xm > 20 ? 100 * 400 / lmax(xm * xm, 1) : 100);
        const long long bm = sym < 6 ? a.bm[(long long)rd * 6 + sym] : 0;
        add(o + O_a2BM2, bm > 20 ? 100 * 400 / lmax(bm * bm, 1) : 100);
    }

    const bool high = bq >= a.highbq;
    const bool gate = isgap ? (fl & F_FAR_INDEL) != 0 : high;
    const bool tier2 = isgap || high;
    const bool gp = gate && is_far, gu = gate && is_unaff;
    add(o + O_aLP1, gp && seg_l + indel_len >= th[TH_aLP1t]);
    add(o + O_aLP2, gp && tier2 && seg_l + indel_len >= th[TH_aLP2t]);
    add(o + O_aRP1, gp && seg_r >= th[TH_aRP1t]);
    add(o + O_aRP2, gp && tier2 && seg_r >= th[TH_aRP2t]);
    add(o + O_aLPL, gp ? seg_l : 0);
    add(o + O_aRPL, gp ? seg_r : 0);
    add(o + O_aLB1, gu && seg_l_baq >= a.bias_baq1);
    add(o + O_aLB2, gu && tier2 && seg_l_baq >= a.bias_baq2);
    add(o + O_aRB1, gu && seg_r_baq >= a.bias_baq1);
    add(o + O_aRB2, gu && tier2 && seg_r_baq >= a.bias_baq2);
    add_big(ob + B_aLBL * PN, gu ? seg_l_baq : 0);
    add_big(ob + B_aRBL * PN, gu ? seg_r_baq : 0);
    add(o + O_aBQ2, gate);

    const bool mate_ok = (flag & 0x8) == 0 || (flag & 0x1) == 0;
    const bool is_norm = isize != 0 || !paired;
    const bool pos_good = !is_amp || (is_far && is_unaff);
    const bool nonb = mate_ok && (isrc ? seg_l > seg_r : seg_l < seg_r);
    const bool norm = is_norm || (isgap && nonb);
    // isrc: the left insert end (aLI*), else the right one (aRI*)
    const long long d2 = isrc ? frag_l2 : frag_r2;
    const int k1t = isrc ? TH_aLI1t : TH_aRI1t;
    const int k1T = isrc ? TH_aLI1T : TH_aRI1T;
    const int k2t = isrc ? TH_aLI2t : TH_aRI2t;
    const int k2T = isrc ? TH_aLI2T : TH_aRI2T;
    add(o + (isrc ? O_aLI1 : O_aRI1),
        d2 >= th[k1t] && (d2 <= th[k1T] || isgap) && norm);
    add(o + (isrc ? O_aLI2 : O_aRI2),
        d2 >= th[k2t] && (d2 <= th[k2T] || isgap) && norm && pos_good);
    add(o + (isrc ? O_aLIr : O_aRIf), pos_good);
}

__global__ void __launch_bounds__(T) pc_adp4(Args a) {
    const long long i = (long long)blockIdx.x * T + threadIdx.x;
    if (i >= (long long)a.P * NS) return;
    const int* o = a.out + i * N_PLANES;
    // the host sums the four int32 planes in int32, then widens
    const unsigned s = (unsigned)o[O_aDPff] + (unsigned)o[O_aDPfr]
                       + (unsigned)o[O_aDPrf] + (unsigned)o[O_aDPrr];
    a.adp4[i] = static_cast<int>(s);
}

unsigned grid_for(long long n) { return (unsigned)((n + T - 1) / T); }

}  // namespace

// Pass C of one region on ``stream``: the arena's slots at addresses
// addr[N_SLOTS], the parameters prm[N_PARAMS].  Inputs must be uploaded;
// the outputs are zeroed here.  With ``sync_each`` the stream is
// synchronised after each launch (a fault shows at its kernel; the card
// test's mode).  Returns the CUDA error code.
extern "C" int uvc_pc_scatter(const long long* addr, const long long* prm,
                              int sync_each, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto at = [addr](int s) { return reinterpret_cast<char*>(addr[s]); };
    Args a;
    a.pos = (const int*)at(S_POS);
    a.sym = (const signed char*)at(S_SYM);
    a.val = (const int*)at(S_VAL);
    a.read = (const int*)at(S_READ);
    a.ilen = (const int*)at(S_ILEN);
    a.flags = (const unsigned char*)at(S_FLAGS);
    a.reads = (const int*)at(S_READS);
    a.bm = (const int*)at(S_BM);
    a.thres = (const int*)at(S_THRES);
    a.baq = (const int*)at(S_BAQ);
    a.baq2 = (const int*)at(S_BAQ2);
    a.out = (int*)at(S_OUT);
    a.big = (long long*)at(S_BIG);
    a.err = (int*)at(S_ERR);
    a.adp4 = (long long*)at(S_ADP4);
    a.n = prm[P_N];
    a.P = (int)prm[P_P];
    a.R = (int)prm[P_R];
    a.interfering_indel = prm[P_INTERFERING_INDEL];
    a.primerlen2 = prm[P_PRIMERLEN2];
    a.is_high_readlen = prm[P_IS_HIGH_READLEN];
    a.baq_mul_1024 = prm[P_BAQ_MUL_1024];
    a.highbaq = prm[P_HIGHBAQ];
    a.highbq = prm[P_HIGHBQ];
    a.pfbq1 = prm[P_PFBQ1];
    a.pfbq2 = prm[P_PFBQ2];
    a.bias_baq1 = prm[P_BIAS_BAQ1];
    a.bias_baq2 = prm[P_BIAS_BAQ2];
    a.nobias_indel_maxlen = prm[P_NOBIAS_INDEL_MAXLEN];
    a.max_insert = prm[P_MAX_INSERT];
    if (a.n < 1 || a.R < 1 || a.P < 1 || a.P >= (1 << 25))
        return (int)cudaErrorInvalidValue;

    const long long PN = (long long)a.P * NS;
    cudaError_t e = cudaMemsetAsync(a.out, 0, PN * N_PLANES * sizeof(int), st);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(a.big, 0, PN * N_BIG * sizeof(long long), st);
    if (e == cudaSuccess) e = cudaMemsetAsync(a.err, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
#define UVC_PC_DONE()                                          \
    do {                                                       \
        e = cudaGetLastError();                                \
        if (e == cudaSuccess && sync_each)                     \
            e = cudaStreamSynchronize(st);                     \
        if (e != cudaSuccess) return (int)e;                   \
    } while (0)
    pc_scatter<<<grid_for(a.n), T, 0, st>>>(a);
    UVC_PC_DONE();
    pc_adp4<<<grid_for(PN), T, 0, st>>>(a);
    UVC_PC_DONE();
#undef UVC_PC_DONE
    return 0;
}
