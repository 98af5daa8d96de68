// The family chain of host prepare on the card: the fragment merge with
// pass D, the family merge with sweep 1, and sweep 2, over one region's
// rows kept in device memory between the kernels.
//
// Replaces no TPU kernel.  The JAX package runs this chain as host C++
// (native/rowpile.cpp: frag_cons_direct with pass D fused into its flush
// (frag_cons_arm_pass_d, pdx_run_frag), then fam_chain_statics); the
// port's host route runs the same library.  This file gives the chain a
// device route (family/device_chain.py, which also holds the plain PyTorch
// version of each kernel) and reproduces the host route array for array,
// rows in the host's order.
//
// Memory: one device arena a worker thread; the wrapper lays out the slots
// below (Slot, in this order) and passes their addresses.  Inputs are
// uploaded in one copy, narrowed to int32 (sym to int8); the first six (the
// event columns, bg and aDP4) may instead lie where pass C's arena holds
// them (csrc/pass_c.cu), and are then not uploaded again.  Row tables are
// columns.  Those that stay on the card (cons, s2) have the stride of
// their capacity n: column c starts at c * n.  Those read back (mut, win,
// g1, m2) are packed in one slot (ROWS), in that order, each table's
// columns at the stride of its row count (rows_of): the scan before each
// write kernel has set the counts, and the rows come back in one copy.
//
// Kernels, in launch order (uvc_fc_chain):
//   fc_offsets    each (stream, read)'s event range by binary search, and
//                 the host's checks on the events (read-major streams,
//                 keys strictly rising within a read, ranges)
//   fc_merge<0>   one warp a fragment: its reads' stream lists merged by
//                 key (a warp k-way merge: each lane holds up to two
//                 lists, __reduce_min_sync picks the next key, the max
//                 over the reads that hold it), the consensus rule of
//                 frag_cons_direct (a read alone, or two mates whose key
//                 ranges do not overlap, take its direct_range rule: base
//                 rows their own group), and pass D's per-row counters by
//                 integer atomics; counts rows, mut rows and win rows
//   chain_scan    one block: exclusive scan of the counts into offsets
//   fc_merge<1>   the same merge, writing the consensus rows, the mut and
//                 win rows at the fragment's offsets (host order)
//   fc_tail       one warp a fragment: n_cov and n_near of pass D over
//                 the written rows, then bta/btb by atomics
//   fam_merge<0>  one warp a family: extents (fbeg/fend); a family of one
//                 fragment (no UMIs) row-parallel, each row its own group,
//                 as the host's per-row path; a larger family (UMIs) by a
//                 warp k-way merge (up to 128 fragments, four lists a
//                 lane) with the sums of acc1/acc2 a key; sweep 1 into the
//                 seven counters interleaved per (pos, sym, strand) as
//                 fam_chain_statics keeps them; counts s2 and good rows
//   chain_scan, fam_merge<1>   the same, writing the s2 rows and the good
//                 rows in the host's order
//   fam_sweep2    one thread an s2 row, after sweep 1 over the whole grid:
//                 cdp1, realphred (computed directly; the host's memo is a
//                 cache of the same value), hist, the mut flag
//   chain_scan, fam_m2   the m2 rows in the host's order
//   fam_planes    the seven interleaved counters into their planes
//
// Numbers: integer work only, but for realphred, a log of a quotient
// (--fmad=false: every + - * / rounds alone, as on the host).  CUDA's log
// is within 1 ulp, glibc's within 1 ulp, so where a rounded use of it
// (indep, and the cap of an indel row) lies within 1e-9 of a .5 the
// kernel flags the region (E_ROUND) and the wrapper runs the host route:
// a rounded value never differs from the host's.  pow(10, -q/10) comes
// from the host's own table.  Every check the host makes that would send
// it off its statics path flags the region too (E_*): the host route then
// runs it, exactly as before.
//
// Bound: memory traffic.  Each input read once (13 bytes an event row,
// the P-sized planes and tables), each output written once (the planes,
// fbeg/fend and the rows read back); the consensus rows and s2 rows that
// stay on the card are each written once and read once.  The merges walk
// their lists serially a key at a time (latency, not bandwidth, bounds
// them); chip_smoke.py reports the share reached.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NOKEY = 0xffffffffu;
constexpr int NS = 14;
constexpr int MAX_READS = 8;      // reads a fragment (the host's limit)
constexpr int MAX_STREAMS = 8;    // event streams a region
constexpr int MAX_LISTS = MAX_READS * MAX_STREAMS;
constexpr int MAX_FAM = 128;      // fragments a family (four lists a lane)
constexpr int WARPS = 8;          // warps a block of the warp kernels

// the arena's slots, in the order of family/device_chain.py SLOTS
enum Slot {
    S_POS, S_SYM, S_VAL, S_READ, S_BG, S_ADP4, S_STREAM_OFF, S_FRAG_OFF,
    S_FRAG_READ, S_FRAG_STRAND, S_MQ2, S_FAM_OFF, S_FAM_FRAG, S_FAM_STRAND,
    S_FAM_DFLAG, S_REF, S_SSCS, S_POW10,
    S_BDP, S_BTA, S_BTB, S_HIST_D, S_VQ_BMQ, S_CDP12, S_CDP21, S_CDP2,
    S_CDP3, S_CDPM_MINOR, S_CDPM_MAJOR, S_CDP1, S_HIST_F, S_FBEG, S_FEND,
    S_COUNTS, S_IL, S_FAM_M2N,
    S_SOFF, S_FRAG_CNT, S_FRAG_OFFS, S_CONS, S_ROWMUT, S_FAM_CNT,
    S_FAM_OFFS, S_FAM_M2OFF, S_S2, S_S2FLAG,
    S_ROWS,
    N_SLOTS
};

// scalar parameters, in the order of family/device_chain.py PARAMS
enum Param {
    P_P, P_N, P_S, P_R, P_F, P_NF, P_HIGHBQ, P_MUT_WINDOW, P_HIGHBQ_SNV,
    P_PDEL_IGN, P_DUP1ADD, P_DUP1PERC, P_DUP2ADD, P_DUP2PERC, P_FLAG2,
    P_EMPERR_SNV, P_EMPERC_SNV, P_EMPERR_INDEL, P_EMPERC_INDEL,
    P_RESCUE_ADD, P_INDEL_INC, P_NPOW10,
    N_PARAMS
};

// counts[], read back with the planes
enum Count { C_ERR, C_OUT, C_MUT, C_WIN, C_S2, C_G1, C_M2, N_COUNTS };

// error bits: each sends the region to the host route
enum Err {
    E_EVENTS = 1, E_READS = 2, E_DUP = 4, E_ROWS = 8, E_ROUND = 16,
    E_AVGBQ = 32, E_FAMSIZE = 64
};

struct Args {
    const int* pos; const signed char* sym; const int* val; const int* read;
    const int* stream_off; const int* frag_off; const int* frag_read;
    const int* frag_strand; const int* mq2; const int* fam_off;
    const int* fam_frag; const int* fam_strand; const int* fam_dflag;
    const long long* bg; const long long* adp4; const int* ref;
    const int* sscs; const double* pow10;
    int* bdp; int* bta; int* btb; int* hist_d; int* vq_bmq;
    int* hist_f; long long* fbeg; long long* fend; int* counts;
    int* il; int* fam_m2n; int* planes[7];
    int* soff; int* frag_cnt; int* frag_offs; int* cons;
    unsigned char* rowmut; int* fam_cnt; int* fam_offs; int* fam_m2off;
    int* s2; unsigned char* s2flag;
    int* rows;
    long long n;          // event rows: the capacity of every row table
    int P, S, R, F, NF;
    int highbq, mut_window, highbq_snv, pdel_ign, dup1add, dup1perc;
    int dup2add, dup2perc, flag2, emperr_snv, emperc_snv, emperr_indel;
    int emperc_indel, rescue_add, indel_inc, npow10;
    double inv_log10;
};

__device__ __forceinline__ unsigned rkey(int pos, int sym) {
    return ((unsigned)pos << 4) | (unsigned)sym;
}

__device__ __forceinline__ bool failed(const Args& a) {
    return *(volatile const int*)(a.counts + C_ERR) != 0;
}

__device__ __forceinline__ void flag(const Args& a, int bit) {
    atomicOr(a.counts + C_ERR, bit);
}

// a table of the ROWS slot: its first column and its row count (the
// stride of its columns)
enum Table { T_MUT, T_WIN, T_G1, T_M2, N_TABLES };
struct Rows { int* p; long long m; };

__device__ __forceinline__ Rows rows_of(const Args& a, int t) {
    const int ncol[N_TABLES] = {4, 3, 6, 5};
    const int cnt[N_TABLES] = {C_MUT, C_WIN, C_G1, C_M2};
    int* p = a.rows;
    for (int i = 0; i < t; ++i) p += (long long)ncol[i] * a.counts[cnt[i]];
    return {p, (long long)a.counts[cnt[t]]};
}

__device__ __forceinline__ long long warp_sum(long long v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// true where rounding x to the nearest integer could go either way
// between two logs that differ by a few ulp
__device__ __forceinline__ bool near_half(double x) {
    const double f = x - floor(x);
    return fabs(f - 0.5) <= 1e-9 * fmax(1.0, fabs(x));
}

// ---- fc_offsets -------------------------------------------------------

__global__ void fc_offsets(Args a) {
    const long long nso = (long long)a.S * (a.R + 1);
    const long long total = nso + a.n;
    for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         it < total; it += (long long)gridDim.x * blockDim.x) {
        if (it < nso) {
            const int s = (int)(it / (a.R + 1)), r = (int)(it % (a.R + 1));
            int lo = a.stream_off[s], hi = a.stream_off[s + 1];
            while (lo < hi) {
                const int mid = lo + ((hi - lo) >> 1);
                if (a.read[mid] < r) lo = mid + 1; else hi = mid;
            }
            a.soff[it] = lo;
            continue;
        }
        const int i = (int)(it - nso);
        int s = 0;
        while (a.stream_off[s + 1] <= i) ++s;
        const int rd = a.read[i], p = a.pos[i], sy = a.sym[i];
        bool bad = rd < 0 || rd >= a.R || p < 0 || p >= a.P || sy < 0
            || sy >= NS || a.val[i] < 0;
        if (!bad && i > a.stream_off[s]) {
            const int rp = a.read[i - 1];
            bad = rd < rp
                || (rd == rp && rkey(p, sy) <= rkey(a.pos[i - 1], a.sym[i - 1]));
        }
        if (bad) flag(a, E_EVENTS);
    }
}

// ---- fc_merge ---------------------------------------------------------

struct FragLists {
    int cur[MAX_LISTS], end[MAX_LISTS];
    unsigned char slot[MAX_LISTS];
    int ua[2], ub[2];     // list ranges of the units
    int nunit, single, bad;
};

// lane 0: the fragment's (read, stream) lists and its units
__device__ void frag_setup(const Args& a, int f, FragLists& L) {
    const int r_lo = a.frag_off[f], r_hi = a.frag_off[f + 1];
    L.nunit = 0;
    L.single = 1;
    L.bad = 0;
    if (r_hi - r_lo > MAX_READS) {
        L.bad = E_READS;
        return;
    }
    int nr = 0, nl = 0;
    int rl0[2] = {0, 0}, rl1[2] = {0, 0};
    unsigned first[2] = {NOKEY, NOKEY}, last[2] = {0, 0};
    for (int ri = r_lo; ri < r_hi; ++ri) {
        const int r = a.frag_read[ri];
        const int l0 = nl;
        unsigned fk = NOKEY, lk = 0;
        for (int s = 0; s < a.S; ++s) {
            const long long b = (long long)s * (a.R + 1) + r;
            const int lo = a.soff[b], hi = a.soff[b + 1];
            if (lo < hi) {
                L.cur[nl] = lo;
                L.end[nl] = hi;
                L.slot[nl] = (unsigned char)nr;
                ++nl;
                const unsigned k0 = rkey(a.pos[lo], a.sym[lo]);
                const unsigned k1 = rkey(a.pos[hi - 1], a.sym[hi - 1]);
                fk = k0 < fk ? k0 : fk;
                lk = k1 > lk ? k1 : lk;
            }
        }
        if (nl > l0) {
            if (nr < 2) {
                rl0[nr] = l0;
                rl1[nr] = nl;
                first[nr] = fk;
                last[nr] = lk;
            }
            ++nr;
        }
    }
    if (nr == 0) return;
    if (nr == 2 && (last[0] < first[1] || last[1] < first[0])) {
        // non-overlapping mates: each read alone, the earlier keys first
        const int u0 = first[1] < first[0] ? 1 : 0;
        L.ua[0] = rl0[u0]; L.ub[0] = rl1[u0];
        L.ua[1] = rl0[1 - u0]; L.ub[1] = rl1[1 - u0];
        L.nunit = 2;
    } else {
        L.ua[0] = 0;
        L.ub[0] = nl;
        L.nunit = 1;
        L.single = nr == 1;
    }
}

// one consensus row of fragment f: pass D's counters (count pass) or the
// row, its mut and win rows (write pass), by lane 0; all lanes count
template <bool WRITE>
__device__ __forceinline__ void frag_emit(
    const Args& a, int f, int strand, int mq2, int lane, int p, int st,
    int cs, long long cc64, long long tt64, int& n_out, int& n_mut,
    int& n_win, int ob, int mb, int wb, const Rows& mt, const Rows& wt) {
    const int cc = (int)cc64, tt = (int)tt64;   // the host's int32 rows
    const int cq = cc * 2 - tt;
    bool mut, win = false;
    if (st == 0) {
        const int rs = a.ref[p];
        mut = rs != cs && rs < 4 && cs < 4 && cq >= a.highbq;
    } else {
        mut = cs != 6 && cs != 13;
        win = cs >= 7 && cs <= 12;
    }
    if (lane == 0) {
        const long long n = a.n;
        if (!WRITE) {
            const int idx = p * NS + cs;
            long long d = a.adp4[idx];
            d = d > 1 ? d : 1;
            const long long maxq = 8 + a.bg[idx] / d;
            const long long pl = cq < maxq ? cq : maxq;
            long long pb = maxq - pl;
            pb = pb < 0 ? 0 : pb;
            if (pb < 16) atomicAdd(a.hist_d + idx * 16 + pb, 1);
            atomicAdd(a.bdp + idx * 2 + strand, 1);
            atomicAdd(a.vq_bmq + idx, mq2);
        } else {
            const long long k = ob + n_out;
            a.cons[k] = f;
            a.cons[n + k] = p;
            a.cons[2 * n + k] = st;
            a.cons[3 * n + k] = cs;
            a.cons[4 * n + k] = cc;
            a.cons[5 * n + k] = tt;
            a.rowmut[k] = mut ? 1 : 0;
            if (mut) {
                const long long m = mb + n_mut;
                mt.p[m] = f;
                mt.p[mt.m + m] = p;
                mt.p[2 * mt.m + m] = st;
                mt.p[3 * mt.m + m] = cs;
            }
            if (win) {
                const long long w = wb + n_win;
                wt.p[w] = f;
                wt.p[wt.m + w] = p;
                wt.p[2 * wt.m + w] = cs;
            }
        }
    }
    ++n_out;
    n_mut += mut ? 1 : 0;
    n_win += win ? 1 : 0;
}

template <bool WRITE>
__global__ void __launch_bounds__(WARPS * 32) fc_merge(Args a) {
    __shared__ FragLists sh[WARPS];
    if (failed(a)) return;
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    FragLists& L = sh[wib];
    const int F1 = a.F + 1;
    Rows mt{nullptr, 0}, wt{nullptr, 0};
    if (WRITE) {
        mt = rows_of(a, T_MUT);
        wt = rows_of(a, T_WIN);
    }
    for (int f = blockIdx.x * WARPS + wib; f < a.F; f += gridDim.x * WARPS) {
        if (lane == 0) frag_setup(a, f, L);
        __syncwarp();
        const int strand = a.frag_strand[f], mq2 = a.mq2[f];
        int ob = 0, mb = 0, wb = 0;
        if (WRITE) {
            ob = a.frag_offs[f];
            mb = a.frag_offs[F1 + f];
            wb = a.frag_offs[2 * F1 + f];
        }
        int n_out = 0, n_mut = 0, n_win = 0;
        bool dup = false;
        if (L.bad && lane == 0) flag(a, L.bad);
        for (int u = 0; u < L.nunit; ++u) {
            const int l0 = L.ua[u], l1 = L.ub[u];
            const bool single = L.single != 0;
            int c[2], e[2], sl[2];
            unsigned k[2];
            for (int t = 0; t < 2; ++t) {
                const int li = l0 + lane + 32 * t;
                k[t] = NOKEY;
                c[t] = e[t] = sl[t] = 0;
                if (li < l1) {
                    c[t] = L.cur[li];
                    e[t] = L.end[li];
                    sl[t] = L.slot[li];
                    k[t] = rkey(a.pos[c[t]], a.sym[c[t]]);
                }
            }
            bool open = false;
            int gp = 0, gst = 0, bs = -1;
            long long tot = 0, bv = -1, lm = 0;
            while (true) {
                const unsigned mk = __reduce_min_sync(
                    FULL, k[0] < k[1] ? k[0] : k[1]);
                if (mk == NOKEY) break;
                int acc = INT_MIN, cnt = 0;
                unsigned sm = 0;
                for (int t = 0; t < 2; ++t) {
                    if (k[t] != mk) continue;
                    const int v = a.val[c[t]];
                    acc = v > acc ? v : acc;
                    sm |= 1u << sl[t];
                    ++cnt;
                    ++c[t];
                    k[t] = c[t] < e[t] ? rkey(a.pos[c[t]], a.sym[c[t]]) : NOKEY;
                }
                acc = __reduce_max_sync(FULL, acc);
                cnt = (int)__reduce_add_sync(FULL, (unsigned)cnt);
                sm = __reduce_or_sync(FULL, sm);
                dup = dup || cnt != __popc(sm);
                const int s = (int)(mk & 15), p = (int)(mk >> 4);
                const int st = s >= 6 ? 1 : 0;
                if (!open || p != gp || st != gst || (single && !st)) {
                    if (open && tot > 0)
                        frag_emit<WRITE>(a, f, strand, mq2, lane, gp, gst,
                                         bs < 0 ? 6 : bs, bs < 0 ? lm : bv,
                                         gst ? (bs < 0 ? lm : bv) : tot,
                                         n_out, n_mut, n_win, ob, mb, wb,
                                         mt, wt);
                    open = true;
                    gp = p;
                    gst = st;
                    tot = 0;
                    bv = -1;
                    bs = -1;
                    lm = 0;
                }
                if (acc > 0) {
                    tot += acc;
                    if (st && s == 6) lm = acc;
                    else if (acc > bv) { bv = acc; bs = s; }
                }
            }
            if (open && tot > 0)
                frag_emit<WRITE>(a, f, strand, mq2, lane, gp, gst,
                                 bs < 0 ? 6 : bs, bs < 0 ? lm : bv,
                                 gst ? (bs < 0 ? lm : bv) : tot,
                                 n_out, n_mut, n_win, ob, mb, wb, mt, wt);
        }
        if (lane == 0) {
            if (dup) flag(a, E_DUP);
            if (!WRITE) {
                a.frag_cnt[f] = n_out;
                a.frag_cnt[F1 + f] = n_mut;
                a.frag_cnt[2 * F1 + f] = n_win;
            }
        }
        __syncwarp();
    }
}

// ---- chain_scan: one block, exclusive scan of ncol count columns ------

__global__ void __launch_bounds__(1024) chain_scan(
    const int* cnt, int* off, int m, int ncol, int* totals) {
    __shared__ int warp_tot[32];
    __shared__ int carry_sh;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    for (int c = 0; c < ncol; ++c) {
        const int* in = cnt + (long long)c * (m + 1);
        int* out = off + (long long)c * (m + 1);
        int carry = 0;
        for (int base = 0; base < m; base += 1024) {
            const int i = base + tid;
            const int v = i < m ? in[i] : 0;
            int x = v;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, x, o);
                if (lane >= o) x += y;
            }
            if (lane == 31) warp_tot[w] = x;
            __syncthreads();
            if (w == 0) {
                int t = warp_tot[lane];
                for (int o = 1; o < 32; o <<= 1) {
                    const int y = __shfl_up_sync(FULL, t, o);
                    if (lane >= o) t += y;
                }
                warp_tot[lane] = t;       // inclusive over warps
            }
            __syncthreads();
            const int before = w ? warp_tot[w - 1] : 0;
            if (i < m) out[i] = carry + before + x - v;
            if (tid == 0) carry_sh = carry + warp_tot[31];
            __syncthreads();
            carry = carry_sh;
            __syncthreads();
        }
        if (tid == 0) {
            out[m] = carry;
            totals[c] = carry;
        }
    }
}

// ---- fc_tail: pass D's n_cov / n_near and bta / btb -------------------

__global__ void __launch_bounds__(WARPS * 32) fc_tail(Args a) {
    if (failed(a)) return;
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const long long n = a.n;
    const int* cpos = a.cons + n;
    const int* ccs = a.cons + 3 * n;
    const int W = a.mut_window;
    for (int f = blockIdx.x * WARPS + wib; f < a.F; f += gridDim.x * WARPS) {
        const int o0 = a.frag_offs[f], o1 = a.frag_offs[f + 1];
        if (o0 == o1) continue;
        const int strand = a.frag_strand[f];
        int ncov = 0, nnear = 0;
        for (int j = o0 + lane; j < o1; j += 32) {
            const int p = cpos[j];
            if (j != o0 && cpos[j - 1] == p) continue;
            ++ncov;
            int lo = o0, hi = o1;
            while (lo < hi) {
                const int mid = lo + ((hi - lo) >> 1);
                if (cpos[mid] < p - W) lo = mid + 1; else hi = mid;
            }
            for (; lo < o1 && cpos[lo] <= p + W; ++lo)
                if (a.rowmut[lo]) { ++nnear; break; }
        }
        ncov = (int)__reduce_add_sync(FULL, (unsigned)ncov);
        nnear = (int)__reduce_add_sync(FULL, (unsigned)nnear);
        for (int j = o0 + lane; j < o1; j += 32) {
            const int idx = (cpos[j] * NS + ccs[j]) * 2 + strand;
            atomicAdd(a.bta + idx, ncov);
            if (nnear) atomicAdd(a.btb + idx, nnear);
        }
    }
}

// ---- fam_merge ----------------------------------------------------------

template <bool WRITE>
__global__ void __launch_bounds__(WARPS * 32) fam_merge(Args a) {
    if (failed(a)) return;
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1;
    const long long n = a.n;
    const int* fo = a.frag_offs;      // each fragment's consensus rows
    const int* cp = a.cons + n;
    const int* cst = a.cons + 2 * n;
    const int* ccs = a.cons + 3 * n;
    const int* ccc = a.cons + 4 * n;
    const int* ctt = a.cons + 5 * n;
    const int NF1 = a.NF + 1;
    const Rows gt = WRITE ? rows_of(a, T_G1) : Rows{nullptr, 0};
    for (int fm = blockIdx.x * WARPS + wib; fm < a.NF;
         fm += gridDim.x * WARPS) {
        const int f_lo = a.fam_off[fm], f_hi = a.fam_off[fm + 1];
        const int k = f_hi - f_lo;
        const int strand = a.fam_strand[fm];
        const bool fam_ok = (a.fam_dflag[fm] & 1) || a.flag2;
        int n_s2 = 0, n_g1 = 0, sb = 0, gb = 0;
        if (WRITE) {
            sb = a.fam_offs[fm];
            gb = a.fam_offs[NF1 + fm];
        } else {
            int b = INT_MAX, e = -1;
            for (int i = f_lo + lane; i < f_hi; i += 32) {
                const int fr = a.fam_frag[i], r0 = fo[fr], r1 = fo[fr + 1];
                if (r0 < r1) {
                    b = cp[r0] < b ? cp[r0] : b;
                    e = cp[r1 - 1] > e ? cp[r1 - 1] : e;
                }
            }
            b = __reduce_min_sync(FULL, b);
            e = __reduce_max_sync(FULL, e);
            if (lane == 0) {
                a.fbeg[fm] = b == INT_MAX ? LLONG_MAX : b;
                a.fend[fm] = e;
            }
        }
        if (k == 1) {
            // one fragment, rows one per (pos, st): each row its own group
            const int fr = a.fam_frag[f_lo], r0 = fo[fr], r1 = fo[fr + 1];
            const bool good1 = 1 >= a.dup1add && 100 >= a.dup1perc && fam_ok;
            const bool c3 = 1 >= a.dup2add && 100 >= a.dup2perc;
            for (int j0 = r0; j0 < r1; j0 += 32) {
                const int j = j0 + lane;
                bool keep = false, a1 = false;
                int p = 0, st = 0, cs = 0, adj = 0;
                if (j < r1) {
                    p = cp[j];
                    st = cst[j];
                    cs = ccs[j];
                    adj = 2 * ccc[j] - ctt[j];
                    if (!WRITE && j > r0
                        && rkey(p, cs) <= rkey(cp[j - 1], ccs[j - 1]))
                        flag(a, E_ROWS);
                    keep = adj > 0;
                    a1 = keep && (st == 1 || (adj >= a.highbq_snv
                                              && !(a.pdel_ign && cs >= 4)));
                }
                const bool g = a1 && good1;
                const unsigned bk = __ballot_sync(FULL, keep);
                const unsigned bgd = __ballot_sync(FULL, g);
                if (!WRITE) {
                    if (a1) {
                        int* il = a.il + ((long long)(p * NS + cs) * 2 + strand) * 7;
                        atomicAdd(il, 1);
                        atomicAdd(il + 1, 1);
                        if (good1) atomicAdd(il + 2, 1);
                        if (c3) atomicAdd(il + 3, 1);
                        const bool base = cs < 6;
                        if (1 >= (base ? a.emperr_snv : a.emperr_indel)
                            && 100 >= (base ? a.emperc_snv : a.emperc_indel))
                            atomicAdd(il + 5, base ? 5 : 7);
                    }
                } else {
                    if (keep) {
                        const long long s = sb + n_s2 + __popc(bk & lt);
                        a.s2[s] = fm;
                        a.s2[n + s] = p;
                        a.s2[2 * n + s] = cs | (st << 4) | (strand << 5);
                        a.s2[3 * n + s] = adj;
                        a.s2[4 * n + s] = adj;
                        a.s2[5 * n + s] = a1 ? 1 : 0;
                        a.s2[6 * n + s] = a1 ? 1 : 0;
                    }
                    if (g) {
                        const long long q = gb + n_g1 + __popc(bgd & lt);
                        gt.p[q] = fm;
                        gt.p[gt.m + q] = p;
                        gt.p[2 * gt.m + q] = st;
                        gt.p[3 * gt.m + q] = cs;
                        gt.p[4 * gt.m + q] = 1;
                        gt.p[5 * gt.m + q] = 1;
                    }
                }
                n_s2 += __popc(bk);
                n_g1 += __popc(bgd);
            }
        } else if (k > MAX_FAM) {
            if (lane == 0) flag(a, E_FAMSIZE);
        } else if (k > 1) {
            // UMI families: a warp k-way merge over the member fragments
            int c[4], e[4];
            unsigned kk[4];
            for (int t = 0; t < 4; ++t) {
                const int i = f_lo + lane + 32 * t;
                kk[t] = NOKEY;
                c[t] = e[t] = 0;
                if (i < f_hi) {
                    const int fr = a.fam_frag[i];
                    c[t] = fo[fr];
                    e[t] = fo[fr + 1];
                    if (c[t] < e[t]) kk[t] = rkey(cp[c[t]], ccs[c[t]]);
                }
            }
            bool open = false;
            int gp = 0, gst = 0, bs1 = -1, bs2 = -1;
            long long t1 = 0, bv1 = -1, t2 = 0, bv2 = -1, cnf2 = 0;
            auto flush = [&]() {
                if (!open) return;
                if (t1 > 0) {
                    const int cs = bs1;
                    const long long cc = bv1;
                    const bool good = t1 >= a.dup1add
                        && cc * 100 >= t1 * a.dup1perc && fam_ok;
                    if (lane == 0) {
                        if (!WRITE) {
                            int* il = a.il
                                + ((long long)(gp * NS + cs) * 2 + strand) * 7;
                            atomicAdd(il, 1);
                            if (t1 == 1) atomicAdd(il + 1, 1);
                            if (good) atomicAdd(il + 2, 1);
                            if (t1 >= a.dup2add && cc * 100 >= t1 * a.dup2perc)
                                atomicAdd(il + 3, 1);
                            const bool base = cs < 6;
                            const int err = base ? a.emperr_snv : a.emperr_indel;
                            const int erc = base ? a.emperc_snv : a.emperc_indel;
                            if (t1 >= err && cc * 100 >= t1 * erc) {
                                atomicAdd(il + 4, (int)(t1 - cc));
                                atomicAdd(il + 5, (int)(t1 * (base ? 5 : 7)));
                            }
                        } else if (good) {
                            const long long q = gb + n_g1;
                            gt.p[q] = fm;
                            gt.p[gt.m + q] = gp;
                            gt.p[2 * gt.m + q] = gst;
                            gt.p[3 * gt.m + q] = cs;
                            gt.p[4 * gt.m + q] = (int)cc;
                            gt.p[5 * gt.m + q] = (int)t1;
                        }
                    }
                    n_g1 += good ? 1 : 0;
                }
                if (t2 > 0) {
                    if (WRITE && lane == 0) {
                        const long long s = sb + n_s2;
                        a.s2[s] = fm;
                        a.s2[n + s] = gp;
                        a.s2[2 * n + s] = bs2 | (gst << 4) | (strand << 5);
                        a.s2[3 * n + s] = (int)bv2;
                        a.s2[4 * n + s] = (int)t2;
                        a.s2[5 * n + s] = (int)cnf2;
                        a.s2[6 * n + s] = (int)t1;
                    }
                    ++n_s2;
                }
            };
            while (true) {
                unsigned lk = kk[0];
                for (int t = 1; t < 4; ++t) lk = kk[t] < lk ? kk[t] : lk;
                const unsigned mk = __reduce_min_sync(FULL, lk);
                if (mk == NOKEY) break;
                long long s1 = 0, s2 = 0;
                for (int t = 0; t < 4; ++t) {
                    if (kk[t] != mk) continue;
                    const int i = c[t];
                    const int adj = 2 * ccc[i] - ctt[i];
                    if (adj > 0) {
                        s1 += (cst[i] == 1 || (adj >= a.highbq_snv
                                               && !(a.pdel_ign && ccs[i] >= 4)))
                            ? 1 : 0;
                        s2 += adj;
                    }
                    if (++c[t] < e[t]) {
                        const unsigned nk = rkey(cp[c[t]], ccs[c[t]]);
                        if (!WRITE && nk <= mk) flag(a, E_ROWS);
                        kk[t] = nk;
                    } else {
                        kk[t] = NOKEY;
                    }
                }
                s1 = warp_sum(s1);
                s2 = warp_sum(s2);
                if (s2 <= 0) continue;
                const int s = (int)(mk & 15), p = (int)(mk >> 4);
                const int st = s >= 6 ? 1 : 0;
                if (!open || p != gp || st != gst) {
                    flush();
                    open = true;
                    gp = p;
                    gst = st;
                    t1 = 0; bv1 = -1; bs1 = -1;
                    t2 = 0; bv2 = -1; bs2 = -1; cnf2 = 0;
                }
                if (s1 > 0) {
                    t1 += s1;
                    if (s1 > bv1) { bv1 = s1; bs1 = s; }
                }
                t2 += s2;
                if (s2 > bv2) { bv2 = s2; bs2 = s; cnf2 = s1; }
            }
            flush();
        }
        if (!WRITE && lane == 0) {
            a.fam_cnt[fm] = n_s2;
            a.fam_cnt[NF1 + fm] = n_g1;
        }
    }
}

// ---- fam_sweep2: one thread an s2 row -----------------------------------

__global__ void fam_sweep2(Args a) {
    if (failed(a)) return;
    const long long n = a.n;
    const int n2 = a.counts[C_S2];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n2;
         i += gridDim.x * blockDim.x) {
        const int g = a.s2[i], p = a.s2[n + i], meta = a.s2[2 * n + i];
        const long long cc2 = a.s2[3 * n + i], tt2 = a.s2[4 * n + i];
        const long long cnf = a.s2[5 * n + i], tnf = a.s2[6 * n + i];
        const int cs = meta & 15, st = (meta >> 4) & 1, strand = (meta >> 5) & 1;
        const long long idx = (long long)(p * NS + cs) * 2 + strand;
        int* il = a.il + idx * 7;
        atomicAdd(il + 6, 1);                                  // cdp1
        const long long avg = tnf == 0 ? 1 : cc2 / (tnf > 1 ? tnf : 1);
        if (avg < 0 || avg >= a.npow10) {
            flag(a, E_AVGBQ);
            continue;
        }
        const long long major = il[5], minor = il[4];
        const double w = 1.0 / ((double)minor + 1.0);
        const double pw = a.pow10[avg];
        const double realphred = -a.inv_log10 * log(
            ((double)minor + w) / ((double)major + (double)minor + w / pw));
        const double x = (double)(2 * cnf - tnf) * realphred;
        if (near_half(x) || (st == 1 && near_half(realphred))) {
            flag(a, E_ROUND);
            continue;
        }
        const long long indep = (long long)rint(x);
        long long confam;
        if (st == 1) {
            const long long cap = a.indel_inc + (long long)rint(realphred);
            confam = indep < cap ? indep : cap;
        } else {
            const long long cap = 2 * cc2 - tt2;
            confam = indep < cap ? indep : cap;
        }
        if (confam < 1) confam = 1;
        const int rs = a.ref[p];
        const long long max_qual = a.sscs[rs * NS + cs] + a.rescue_add;
        const long long confam2 = confam < max_qual ? confam : max_qual;
        if (tnf >= a.dup1add) {
            const long long d = max_qual - confam2 + 2;
            long long pb = d >= 0 ? d / 4 : -((-d + 3) / 4);
            pb = pb < 0 ? 0 : (pb > 15 ? 15 : pb);
            atomicAdd(a.hist_f + (((long long)strand * a.P + p) * NS + cs) * 16
                      + pb, 1);
        }
        bool mut;
        if (st == 0) mut = rs != cs && rs < 4 && cs < 4 && confam >= a.highbq;
        else mut = cs != 6 && cs != 13;
        const bool ok = tnf >= a.dup1add && cnf * 100 >= tnf * a.dup1perc;
        a.s2flag[i] = (mut ? 1 : 0) | (ok ? 2 : 0);
        if (mut) atomicAdd(a.fam_m2n + g, 1);
    }
}

// ---- fam_m2: the m2 rows, one warp a family -----------------------------

__global__ void __launch_bounds__(WARPS * 32) fam_m2(Args a) {
    if (failed(a)) return;
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1;
    const long long n = a.n;
    const Rows qt = rows_of(a, T_M2);
    for (int fm = blockIdx.x * WARPS + wib; fm < a.NF;
         fm += gridDim.x * WARPS) {
        const int r0 = a.fam_offs[fm], r1 = a.fam_offs[fm + 1];
        const int base = a.fam_m2off[fm];
        int cnt = 0;
        for (int j0 = r0; j0 < r1; j0 += 32) {
            const int j = j0 + lane;
            const int fl = j < r1 ? a.s2flag[j] : 0;
            const unsigned b = __ballot_sync(FULL, fl & 1);
            if (fl & 1) {
                const long long q = base + cnt + __popc(b & lt);
                const int meta = a.s2[2 * n + j];
                qt.p[q] = a.s2[j];
                qt.p[qt.m + q] = a.s2[n + j];
                qt.p[2 * qt.m + q] = (meta >> 4) & 1;
                qt.p[3 * qt.m + q] = meta & 15;
                qt.p[4 * qt.m + q] = (fl >> 1) & 1;
            }
            cnt += __popc(b);
        }
    }
}

// ---- fam_planes: the interleaved counters into their seven planes -------

__global__ void fam_planes(Args a) {
    if (failed(a)) return;
    const long long m = (long long)a.P * NS * 2;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < m; i += (long long)gridDim.x * blockDim.x) {
        const int* il = a.il + i * 7;
        for (int c = 0; c < 7; ++c) a.planes[c][i] = il[c];
    }
}

unsigned grid_for(long long items, int per_block) {
    long long g = (items + per_block - 1) / per_block;
    if (g < 1) g = 1;
    if (g > 8192) g = 8192;
    return (unsigned)g;
}

}  // namespace

// The whole chain of one region on ``stream``: its slots at addresses
// addr[N_SLOTS] (bdp .. s2flag one range of the arena, zeroed at once),
// the parameters prm[N_PARAMS] and 10 / ln 10 as the host computes it.  Inputs must be uploaded; the
// zeroed slots are zeroed here.  With ``sync_each`` the stream is
// synchronised after each launch (a fault shows at its kernel; the card
// test's mode).  Returns the CUDA error code.
extern "C" int uvc_fc_chain(const long long* addr, const long long* prm,
                            double inv_log10, int sync_each, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto at = [addr](int s) { return reinterpret_cast<char*>(addr[s]); };
    Args a;
    a.pos = (const int*)at(S_POS);
    a.sym = (const signed char*)at(S_SYM);
    a.val = (const int*)at(S_VAL);
    a.read = (const int*)at(S_READ);
    a.stream_off = (const int*)at(S_STREAM_OFF);
    a.frag_off = (const int*)at(S_FRAG_OFF);
    a.frag_read = (const int*)at(S_FRAG_READ);
    a.frag_strand = (const int*)at(S_FRAG_STRAND);
    a.mq2 = (const int*)at(S_MQ2);
    a.fam_off = (const int*)at(S_FAM_OFF);
    a.fam_frag = (const int*)at(S_FAM_FRAG);
    a.fam_strand = (const int*)at(S_FAM_STRAND);
    a.fam_dflag = (const int*)at(S_FAM_DFLAG);
    a.bg = (const long long*)at(S_BG);
    a.adp4 = (const long long*)at(S_ADP4);
    a.ref = (const int*)at(S_REF);
    a.sscs = (const int*)at(S_SSCS);
    a.pow10 = (const double*)at(S_POW10);
    a.bdp = (int*)at(S_BDP);
    a.bta = (int*)at(S_BTA);
    a.btb = (int*)at(S_BTB);
    a.hist_d = (int*)at(S_HIST_D);
    a.vq_bmq = (int*)at(S_VQ_BMQ);
    for (int c = 0; c < 7; ++c) a.planes[c] = (int*)at(S_CDP12 + c);
    a.hist_f = (int*)at(S_HIST_F);
    a.fbeg = (long long*)at(S_FBEG);
    a.fend = (long long*)at(S_FEND);
    a.counts = (int*)at(S_COUNTS);
    a.il = (int*)at(S_IL);
    a.fam_m2n = (int*)at(S_FAM_M2N);
    a.soff = (int*)at(S_SOFF);
    a.frag_cnt = (int*)at(S_FRAG_CNT);
    a.frag_offs = (int*)at(S_FRAG_OFFS);
    a.cons = (int*)at(S_CONS);
    a.rowmut = (unsigned char*)at(S_ROWMUT);
    a.fam_cnt = (int*)at(S_FAM_CNT);
    a.fam_offs = (int*)at(S_FAM_OFFS);
    a.fam_m2off = (int*)at(S_FAM_M2OFF);
    a.s2 = (int*)at(S_S2);
    a.s2flag = (unsigned char*)at(S_S2FLAG);
    a.rows = (int*)at(S_ROWS);
    a.n = prm[P_N];
    a.P = (int)prm[P_P]; a.S = (int)prm[P_S]; a.R = (int)prm[P_R];
    a.F = (int)prm[P_F]; a.NF = (int)prm[P_NF];
    a.highbq = (int)prm[P_HIGHBQ]; a.mut_window = (int)prm[P_MUT_WINDOW];
    a.highbq_snv = (int)prm[P_HIGHBQ_SNV]; a.pdel_ign = (int)prm[P_PDEL_IGN];
    a.dup1add = (int)prm[P_DUP1ADD]; a.dup1perc = (int)prm[P_DUP1PERC];
    a.dup2add = (int)prm[P_DUP2ADD]; a.dup2perc = (int)prm[P_DUP2PERC];
    a.flag2 = (int)prm[P_FLAG2];
    a.emperr_snv = (int)prm[P_EMPERR_SNV]; a.emperc_snv = (int)prm[P_EMPERC_SNV];
    a.emperr_indel = (int)prm[P_EMPERR_INDEL];
    a.emperc_indel = (int)prm[P_EMPERC_INDEL];
    a.rescue_add = (int)prm[P_RESCUE_ADD]; a.indel_inc = (int)prm[P_INDEL_INC];
    a.npow10 = (int)prm[P_NPOW10];
    a.inv_log10 = inv_log10;
    if (a.n < 1 || a.S < 1 || a.S > MAX_STREAMS || a.R < 1 || a.F < 1
        || a.NF < 1 || a.P < 1 || a.P >= (1 << 27))
        return (int)cudaErrorInvalidValue;

    cudaError_t e = cudaMemsetAsync(at(S_BDP), 0, addr[S_SOFF] - addr[S_BDP],
                                    st);
    if (e != cudaSuccess) return (int)e;
    const int T = WARPS * 32;
    const unsigned gF = grid_for(a.F, WARPS), gNF = grid_for(a.NF, WARPS);
#define UVC_FC_DONE()                                          \
    do {                                                       \
        e = cudaGetLastError();                                \
        if (e == cudaSuccess && sync_each)                     \
            e = cudaStreamSynchronize(st);                     \
        if (e != cudaSuccess) return (int)e;                   \
    } while (0)
    fc_offsets<<<grid_for((long long)a.S * (a.R + 1) + a.n, 256), 256, 0, st>>>(a);
    UVC_FC_DONE();
    fc_merge<false><<<gF, T, 0, st>>>(a);
    UVC_FC_DONE();
    chain_scan<<<1, 1024, 0, st>>>(a.frag_cnt, a.frag_offs, a.F, 3,
                                   a.counts + C_OUT);
    UVC_FC_DONE();
    fc_merge<true><<<gF, T, 0, st>>>(a);
    UVC_FC_DONE();
    fc_tail<<<gF, T, 0, st>>>(a);
    UVC_FC_DONE();
    fam_merge<false><<<gNF, T, 0, st>>>(a);
    UVC_FC_DONE();
    chain_scan<<<1, 1024, 0, st>>>(a.fam_cnt, a.fam_offs, a.NF, 2,
                                   a.counts + C_S2);
    UVC_FC_DONE();
    fam_merge<true><<<gNF, T, 0, st>>>(a);
    UVC_FC_DONE();
    fam_sweep2<<<grid_for(a.n, 256), 256, 0, st>>>(a);
    UVC_FC_DONE();
    chain_scan<<<1, 1024, 0, st>>>(a.fam_m2n, a.fam_m2off, a.NF, 1,
                                   a.counts + C_M2);
    UVC_FC_DONE();
    fam_m2<<<gNF, T, 0, st>>>(a);
    UVC_FC_DONE();
    fam_planes<<<grid_for((long long)a.P * NS * 2, 256), 256, 0, st>>>(a);
    UVC_FC_DONE();
#undef UVC_FC_DONE
    return 0;
}

extern "C" int uvc_fc_nslots() { return N_SLOTS; }
extern "C" int uvc_fc_nparams() { return N_PARAMS; }
