// B1: the fragment consensus reduction, as two kernel families.
//
// Replaces the JAX package's jitted program
// ops/device_consensus._device_reduce_consensus (uvc_tpu/ops/
// device_consensus.py:58): a stable lexicographic sort of the event rows
// by (invalid, group, pos, sym) (num_keys=4), a segment max or sum over
// duplicate (group, pos, sym) rows, a second stable sort of the unique rows
// by (invalid, group, pos, symbol type, LINK_M class, -val, sym)
// (num_keys=7), and a per-group consensus (first row of each group) with
// the group total.  Plain version: ops/device_consensus.py (dc_sort_plain,
// dc_segments_plain).
//
// Data: every table is int32 "rows of columns" in one buffer buf[A][N];
// column a of row i is buf[a * N + i].
//
// dc_sort (uvc_dc_sort_ranges, then uvc_dc_sort): sorts the rows of buf
// ascending by columns 0..nkeys-1, lexicographically as signed int32,
// stably; the other columns ride along.  Design: a stable LSD radix sort
// over packed key digits.
//   1. key_ranges: each key column's min and max; the wrapper reads them
//      back (one sync per sort) and builds the plan
//      (ops/device_consensus.sort_plan): key k takes
//      w_k = bitlen(max_k - min_k) bits, keys from the last to the first
//      fill 64-bit words without being split, and each word is sorted in
//      8-bit digits, the word of the last keys first.  A key of width 0
//      costs nothing; a table whose keys need more than 64 bits takes more
//      words.
//   2. pack_word: per row the word sum((key_k - min_k) << shift_k) as
//      uint64 and the row index as uint32; a later word reads its key
//      columns through the permutation so far (a gather).
//   3. one pass per digit, reduce-then-scan: digit_hist counts each
//      4,096-row tile's digits into a digit-major [256][tiles] table and
//      the digit totals; digit_scan turns the table into each (digit,
//      tile)'s output offset; digit_scatter ranks the tile's rows stably
//      (__match_any_sync peers per warp step, per-warp digit counters, a
//      prefix over warps and digits), stages them in shared memory in digit
//      order and writes (key, index) in runs to the other buffer of a
//      double-buffered pair.
//   4. gather_rows: every column by the final permutation into scratch,
//      then one copy back into buf (the sort is in place).
// Bound: memory traffic.  A digit pass reads the keys twice and the
// indices once and writes both: 32 bytes a row.  A sort moves that times
// its digit passes, plus the pack, plus 16 A bytes a row to gather and copy
// back: at N = 2^22 on the bench stream 5 + 6 passes for the two sorts,
// about 1.2 and 1.6 GB.  The bitonic network it replaces did O(N log^2 N)
// row moves, 78 device-memory passes at 2^22 that each read and wrote
// every column.  Reduce-then-scan: three plain launches a digit, no
// decoupled look-back between blocks (onesweep) to get right.  8-bit
// digits: a tile's 16 x 256 warp counters and its 4,096 staged rows fit in
// 66 KB of shared memory, and the bench's 35- and 43-bit keys take 5 and 6
// passes.  Digits that are the same for every row are not skipped: that
// needs a second sync per word.
//
// The helpers marked HD also build as host C++ (common.cuh's non-CUDA
// branch): the end of this file runs the same passes on one thread, and a
// CPU test (tests/test_torch_radix_sort.py) holds that run and the Python
// plan to the plain version.
//
// dc_segments (uvc_dc_segments_unique, uvc_dc_segments_groups) replaces
// the program's segment reductions (uvc_tpu/ops/device_consensus.py:71-93,
// stage 1: cumsum segment ids, segment_max/sum of the values and of the
// keys; :105-125, stage 2: the same per (g, p, st) group, segment_min for
// its first row).  Over sorted rows a segment is a run of ok rows with
// equal keys; its start is the first.  Stage 1 writes each unique row at
// its rank with its max or sum, and the stage-2 table; stage 2 writes each
// group's first row with the group's total.  Integer work only, so the
// results are exact; sums wrap in int32 as the JAX program's do.
// Bound: memory traffic.  A row that is not ok joins no segment, so only
// its flag must be read.  Stage 1 must read inval (N ints) and g, p, s and
// v of the n_rows ok rows, and write 4 n_uniq + 9 N; stage 2 reads c_inv
// (N) and g, p, st, s and v of its n_pos ok rows (the unique rows with
// v > 0), and writes 6 n_grp: 4 (11 N + 4 n_rows + 4 n_uniq + 5 n_pos +
// 6 n_grp) bytes a call.
// Design, one pass over the keys per stage (seg_pass), against the costs
// of a split into counting, a one-block scan of the counts, and ranking
// with a walk of each segment:
//   - launches: stage 1 runs seg_pass<1> and seg_tail, stage 2
//     seg_pass<2>; one cudaMemsetAsync in stage 1 zeroes both stages'
//     tile counters and status words (stage 2 zeroes its own half only
//     when it is called without stage 1's scratch);
//   - the scan runs across all blocks, a chained scan with decoupled
//     look-back: tile ids from an atomic counter (a tile waits only on
//     tiles that have started), each tile publishes its count, then its
//     inclusive prefix, in one 64-bit status word (flag and value) with
//     st.release, read with ld.acquire, one warp looking back 32 tiles at
//     a time;
//   - the keys are read once: a block takes a tile of SEG_TILE rows,
//     SEG_ITEMS a thread in registers, each column one 16-byte load a
//     thread (a warp reads 512 contiguous bytes), the rows next to a
//     thread's by shuffles (global loads only at a warp's edge); flags,
//     ranks and the reduce come from registers; a thread whose rows are
//     none of them ok reads only their flags;
//   - stage 1 writes each unique row's stage-2 row in the same store pass,
//     so nothing is read back; seg_tail writes that table's rows beyond
//     n_uniq, known only at the scan's end;
//   - the reduce is a segmented suffix scan of v over the tile (in a
//     thread, then shuffles over the warp, then over the warps), so the
//     thread holding a start has its segment's result with every lane
//     busy; a segment that runs past the tile's end is finished by the
//     tile's last warp, 32 rows a step, coalesced.
// Each start's output row is staged in shared memory at its rank in the
// tile and written out by consecutive threads, a warp's 32 rows aligned
// to 128 bytes of each column.  Tried on the H100 and not kept: tiles of
// 512, 2,048 and 4,096 rows (none faster at both N = 2^20 and 2^22), a
// block-wide look-back and relaxed loads or a back-off in its spin (no
// gain), 16-byte stores of 4 rows a thread (slower).  The HD
// helpers below build as host C++ too: a host driver runs the tiles in
// order on one thread (the look-back a running prefix), held to the plain
// version by tests/test_torch_segments.py.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;     // threads of a scan block
constexpr int MAX_COLS = 9;     // widest table: the stage-2 sort

#ifdef __CUDACC__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

// ---- the radix sort, shared with the host build --------------------------

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_TILE = 4096;                     // rows of a tile
constexpr int SORT_THREADS = 512;                   // threads of a tile block
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int WARP_ROWS = SORT_TILE / SORT_WARPS;   // a warp's run of rows
constexpr int ITEMS = WARP_ROWS / 32;               // rows of a thread
constexpr int MAX_PASSES = 8 * MAX_COLS;            // digit passes of a sort
constexpr long long MAX_ROWS = 1LL << 28;
constexpr int SCATTER_SMEM =
    SORT_TILE * (8 + 4) + (SORT_WARPS + 2) * RADIX * 4;

// One 64-bit word of the plan: its keys' columns, shifts and minima, and
// its number of 8-bit digits.
struct Word {
    int nk, ndig;
    int col[MAX_COLS], shift[MAX_COLS], lo[MAX_COLS];
};

// The plan's int array: nwords, then per word nk, ndig and (column, shift,
// min) per key, least significant word first.  Fills words[]; returns
// their number, or -1 for a plan the sort does not take.
HD int parse_plan(const int* plan, int len, int A, Word* words) {
    if (len < 1 || plan[0] < 0 || plan[0] > MAX_COLS) return -1;
    int at = 1, passes = 0;
    for (int w = 0; w < plan[0]; ++w) {
        if (at + 2 > len) return -1;
        Word& W = words[w];
        W.nk = plan[at];
        W.ndig = plan[at + 1];
        at += 2;
        if (W.nk < 1 || W.nk > MAX_COLS || W.ndig < 1 || W.ndig > 8
            || at + 3 * W.nk > len)
            return -1;
        for (int j = 0; j < W.nk; ++j, at += 3) {
            W.col[j] = plan[at];
            W.shift[j] = plan[at + 1];
            W.lo[j] = plan[at + 2];
            if (W.col[j] < 0 || W.col[j] >= A || W.shift[j] < 0
                || W.shift[j] >= 64)
                return -1;
        }
        passes += W.ndig;
    }
    return at == len && passes <= MAX_PASSES ? plan[0] : -1;
}

// The sort's scratch, carved from one buffer of scratch_bytes(N, A):
// double-buffered keys and indices, the [256][tiles] digit table, the
// digit totals of every pass and the gather's table.
struct Scratch {
    uint64_t* key[2];
    unsigned* idx[2];
    unsigned* hist;
    unsigned* total;
    int* table;
};

HD long long sort_tiles(long long N) {
    return (N + SORT_TILE - 1) / SORT_TILE;
}

HD long long scratch_bytes(long long N, int A) {
    return 2 * N * (8 + 4) + 4LL * RADIX * (sort_tiles(N) + MAX_PASSES)
        + 4LL * A * N;
}

HD Scratch carve(void* p, long long N) {
    Scratch s;
    s.key[0] = static_cast<uint64_t*>(p);
    s.key[1] = s.key[0] + N;
    s.idx[0] = reinterpret_cast<unsigned*>(s.key[1] + N);
    s.idx[1] = s.idx[0] + N;
    s.hist = s.idx[1] + N;
    s.total = s.hist + RADIX * sort_tiles(N);
    s.table = reinterpret_cast<int*>(s.total + RADIX * MAX_PASSES);
    return s;
}

// signed int32 -> uint32 in the same order
HD unsigned key_ord(int x) { return (unsigned)x ^ 0x80000000u; }

// The loop runs to a constant bound so that it unrolls and the kernel
// reads w from its parameters, not from a local copy.
HD uint64_t pack_key(const int* buf, long long N, const Word& w,
                     long long row) {
    uint64_t key = 0;
    for (int j = 0; j < MAX_COLS; ++j)
        if (j < w.nk)
            key |= (uint64_t)((unsigned)buf[w.col[j] * N + row]
                              - (unsigned)w.lo[j]) << w.shift[j];
    return key;
}

HD unsigned digit_of(uint64_t key, int shift) {
    return (unsigned)(key >> shift) & (RADIX - 1);
}

HD int popc32(unsigned x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// Row of a lane's k-th item within the tile: warp w's run of WARP_ROWS
// rows, 32 rows a step, so (warp, step, lane) is the rows' order.
HD int tile_row(int w, int k, int lane) {
    return w * WARP_ROWS + k * 32 + lane;
}

// A lane's stable rank among its warp's rows of digit d so far: the warp's
// count of d before this step plus its peers (the lanes of this step with
// digit d) on lower lanes.  whist is the warp's 256 counters.
HD unsigned rank_read(const unsigned* whist, unsigned d, unsigned peers,
                      int lane) {
    return whist[d] + (unsigned)popc32(peers & ((1u << lane) - 1u));
}

// Once every lane of the step has read: the highest peer stores the count.
HD void rank_commit(unsigned* whist, unsigned d, unsigned peers, int lane,
                    unsigned rank) {
    if ((peers >> lane) == 1u) whist[d] = rank + 1;
}

// Digit d's counts in the tile's warps [SORT_WARPS][RADIX] -> each warp's
// offset among the tile's rows of d; returns the tile's count of d.
HD unsigned warp_offsets(unsigned* whist, int d) {
    unsigned run = 0;
    for (int w = 0; w < SORT_WARPS; ++w) {
        const unsigned c = whist[w * RADIX + d];
        whist[w * RADIX + d] = run;
        run += c;
    }
    return run;
}

// A row's place among the tile's rows staged in digit order: the rows of
// smaller digits (loc), its warp's offset among the rows of d, its rank.
HD int stage_pos(const unsigned* whist, const unsigned* loc, int w,
                 unsigned d, unsigned rank) {
    return (int)(loc[d] + whist[w * RADIX + d] + rank);
}

// ---- the segment passes, shared with the host build -------------------------

constexpr int SEG_THREADS = 256;                     // threads of a tile block
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int SEG_ITEMS = 4;                         // rows of a thread
constexpr int SEG_TILE = SEG_THREADS * SEG_ITEMS;    // rows of a tile
constexpr unsigned long long SEG_AGG = 1ull << 32;   // status: the tile's count
constexpr unsigned long long SEG_PRE = 2ull << 32;   // status: its prefix

HD long long seg_tiles(long long N) {
    return (N + SEG_TILE - 1) / SEG_TILE;
}

// the scratch of a stage: the tile counter (8 bytes), a status word a tile
HD long long seg_stage_bytes(long long N) {
    return 8 + 8 * seg_tiles(N);
}

// the scratch of a call: stage 1's half, then stage 2's
HD long long seg_scratch_bytes(long long N) {
    return 2 * seg_stage_bytes(N);
}

// One row as a stage reads it: the invalid flag, the keys (g, p, k) and
// the symbol and value.  Stage 1 (COLS1): inval 0, g 1, p 2, k = s 3,
// v 5.  Stage 2 (COLS2): c_inv 0, g 1, p 2, k = st 3, s 6, v 8.
struct SegRow {
    int inv, g, p, k, s, v;
};

HD int seg_col_s(int stage) { return stage == 1 ? 3 : 6; }
HD int seg_col_v(int stage) { return stage == 1 ? 5 : 8; }

HD SegRow seg_none() { return SegRow{1, 0, 0, 0, 0, 0}; }  // beyond N

// row i; of a row that is not ok only the flag is read (its keys and
// value join no segment)
HD SegRow seg_row(const int* buf, long long N, int stage, long long i) {
    const int inv = buf[i];
    if (inv) return SegRow{inv, 0, 0, 0, 0, 0};
    return SegRow{inv, buf[N + i], buf[2 * N + i], buf[3 * N + i],
                  buf[seg_col_s(stage) * N + i], buf[seg_col_v(stage) * N + i]};
}

// b continues a's segment
HD bool seg_same(const SegRow& a, const SegRow& b) {
    return a.inv == 0 && b.inv == 0 && a.g == b.g && a.p == b.p && a.k == b.k;
}

// A thread's start and end flags (bit k for its row k), given the row
// before its first and the row after its last: a start is an ok row that
// does not continue the row before; an end a row that the next one does
// not continue (every row that is not ok is one).
HD void seg_flags(const SegRow* r, const SegRow& prev, const SegRow& next,
                  unsigned& start, unsigned& end) {
    start = end = 0;
    UNROLL
    for (int k = 0; k < SEG_ITEMS; ++k) {
        const SegRow& a = k ? r[k - 1] : prev;
        const SegRow& b = k + 1 < SEG_ITEMS ? r[k + 1] : next;
        if (r[k].inv == 0 && !seg_same(a, r[k])) start |= 1u << k;
        if (!seg_same(r[k], b)) end |= 1u << k;
    }
}

// the reduce: max, or a sum wrapping in int32
HD int seg_op(int sum, int a, int b) {
    return sum ? (int)((unsigned)a + (unsigned)b) : (a > b ? a : b);
}

HD int seg_identity(int sum) { return sum ? 0 : INT32_MIN; }

// A suffix of the segmented reduce: v over the rows from one row on, up
// to and including the first end (f = 1), or to the last row seen (f = 0).
struct Seg {
    int v, f;
};

// the suffix of the rows of ``near`` continued by the rows after them
HD Seg seg_join(Seg near, Seg far, int sum) {
    return near.f ? near : Seg{seg_op(sum, near.v, far.v), far.f};
}

// A thread's suffixes from ``carry`` (that of the rows after its last):
// out[k] is row k's; returns row 0's, the thread's aggregate.
HD Seg seg_suffix(const SegRow* r, unsigned end, Seg carry, int sum,
                  Seg* out) {
    UNROLL
    for (int k = SEG_ITEMS - 1; k >= 0; --k) {
        carry = (end >> k) & 1u ? Seg{r[k].v, 1}
                                : Seg{seg_op(sum, r[k].v, carry.v), carry.f};
        out[k] = carry;
    }
    return carry;
}

// Stage 1's unique row u (keys g, p, s; reduced value v) into out_u
// [4][N] and its row of the stage-2 table buf2 [9][N] (COLS2).
HD void seg_write_unique(int* out_u, int* buf2, long long N, long long u,
                         int g, int p, int s, int v, int ovr) {
    const int st = s >= 6;
    out_u[u] = g;
    out_u[N + u] = p;
    out_u[2 * N + u] = s;
    out_u[3 * N + u] = v;
    buf2[u] = !(v > 0);
    buf2[N + u] = g;
    buf2[2 * N + u] = p;
    buf2[3 * N + u] = st;
    buf2[4 * N + u] = (ovr && s == 6 && st) ? 1 : 0;  // LINK_M
    buf2[5 * N + u] = (int)(0u - (unsigned)v);         // -v, wrapping
    buf2[6 * N + u] = s;
    buf2[7 * N + u] = (int)u;
    buf2[8 * N + u] = v;
}

// a row of the stage-2 table at or beyond n_uniq
HD void seg_write_empty(int* buf2, long long N, long long i) {
    buf2[i] = 1;
    for (int a = 1; a < 9; ++a) buf2[a * N + i] = a == 7 ? (int)i : 0;
}

// Stage 2's consensus row gi: the group's first row (g, p, st, s, v) and
// its total.
HD void seg_write_group(int* out_c, long long N, long long gi, int g, int p,
                        int st, int s, int v, int tot, int ovr) {
    out_c[gi] = g;
    out_c[N + gi] = p;
    out_c[2 * N + gi] = st;
    out_c[3 * N + gi] = s;
    out_c[4 * N + gi] = v;
    out_c[5 * N + gi] = (ovr && st == 1) ? v : tot;
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

// Exclusive scan of a[0..n) in place, plus carry; returns carry plus the
// sum.  Every thread of the block calls it; blockDim.x is a multiple of 32.
template <typename T>
__device__ T block_scan(T* a, int n, T carry) {
    __shared__ T warp_sum[32];
    __shared__ T s_carry;
    if (threadIdx.x == 0) s_carry = carry;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const T v = i < n ? a[i] : T(0);
        T x = v;  // inclusive scan within the warp
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) warp_sum[warp] = x;
        __syncthreads();
        if (warp == 0) {
            T s = lane < nw ? warp_sum[lane] : T(0);
            for (int o = 1; o < 32; o <<= 1) {
                const T y = __shfl_up_sync(FULL, s, o);
                if (lane >= o) s += y;
            }
            if (lane < nw) warp_sum[lane] = s;  // inclusive over warps
        }
        __syncthreads();
        const T c = s_carry;
        if (i < n) a[i] = c + (warp ? warp_sum[warp - 1] : T(0)) + x - v;
        __syncthreads();
        if (threadIdx.x == 0) s_carry = c + warp_sum[nw - 1];
        __syncthreads();
    }
    return s_carry;
}

// rng[2k] = the min over key column k (= blockIdx.y) of key_ord, rng[2k+1]
// the min of ~key_ord (the max, complemented); rng comes filled with 0xff.
__global__ void key_ranges(const int* buf, long long N, unsigned* rng) {
    const int* c = buf + blockIdx.y * N;
    unsigned lo = FULL, nhi = FULL;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < N; i += (long long)gridDim.x * blockDim.x) {
        const unsigned o = key_ord(c[i]);
        lo = min(lo, o);
        nhi = min(nhi, ~o);
    }
    lo = __reduce_min_sync(FULL, lo);
    nhi = __reduce_min_sync(FULL, nhi);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(rng + 2 * blockIdx.y, lo);
        atomicMin(rng + 2 * blockIdx.y + 1, nhi);
    }
}

// Word w's key of every row, and for the first word the identity index.
__global__ void pack_word(const int* buf, long long N, Word w, int first,
                          uint64_t* key, unsigned* idx) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const long long row = first ? i : idx[i];
    key[i] = pack_key(buf, N, w, row);
    if (first) idx[i] = (unsigned)i;
}

// hist[d][tile] = the tile's rows of digit d; total[d] += it.
__global__ void __launch_bounds__(SORT_THREADS)
digit_hist(const uint64_t* key, long long N, int shift, unsigned* hist,
           unsigned* total) {
    __shared__ unsigned h[RADIX];
    const int t = threadIdx.x, lane = t & 31;
    if (t < RADIX) h[t] = 0;
    __syncthreads();
    const long long base = (long long)blockIdx.x * SORT_TILE;
    constexpr int ROWS = SORT_TILE / SORT_THREADS;
    unsigned d[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {  // every load in flight before the match
        const long long r = base + k * SORT_THREADS + t;
        d[k] = r < N ? digit_of(key[r], shift) : RADIX;
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const unsigned peers = __match_any_sync(FULL, d[k]);
        if (d[k] < RADIX && (peers >> lane) == 1u)
            atomicAdd(&h[d[k]], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (t < RADIX) {
        hist[(long long)t * gridDim.x + blockIdx.x] = h[t];
        if (h[t]) atomicAdd(total + t, h[t]);
    }
}

// hist[d][tile] -> the output offset of the tile's rows of digit d: the
// rows of smaller digits plus the rows of d in earlier tiles.  One block a
// digit.
__global__ void __launch_bounds__(BLOCK)
digit_scan(unsigned* hist, int tiles, const unsigned* total) {
    __shared__ unsigned below[BLOCK / 32];
    const unsigned d = blockIdx.x;
    unsigned v = threadIdx.x < d ? total[threadIdx.x] : 0u;
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) below[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned base = 0;
    for (int w = 0; w < RADIX / 32; ++w) base += below[w];
    block_scan(hist + (long long)d * tiles, tiles, base);
}

// One stable digit pass over a tile: (key, idx) in -> out at the offsets.
__global__ void __launch_bounds__(SORT_THREADS)
digit_scatter(const uint64_t* key_in, const unsigned* idx_in, long long N,
              int shift, const unsigned* offsets, uint64_t* key_out,
              unsigned* idx_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
    unsigned* s_idx = reinterpret_cast<unsigned*>(s_key + SORT_TILE);
    unsigned* s_whist = s_idx + SORT_TILE;        // [SORT_WARPS][RADIX]
    unsigned* s_loc = s_whist + SORT_WARPS * RADIX;
    int* s_delta = reinterpret_cast<int*>(s_loc + RADIX);
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const long long base = (long long)blockIdx.x * SORT_TILE;
    for (int i = t; i < SORT_WARPS * RADIX; i += SORT_THREADS) s_whist[i] = 0;
    __syncthreads();
    uint64_t key[ITEMS];
    unsigned idx[ITEMS], rank[ITEMS];
    unsigned* wh = s_whist + w * RADIX;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long r = base + tile_row(w, k, lane);
        const bool ok = r < N;
        key[k] = ok ? key_in[r] : 0;
        idx[k] = ok ? idx_in[r] : 0;
        const unsigned d = ok ? digit_of(key[k], shift) : RADIX;
        const unsigned peers = __match_any_sync(FULL, d);
        rank[k] = ok ? rank_read(wh, d, peers, lane) : 0;
        __syncwarp();
        if (ok) rank_commit(wh, d, peers, lane, rank[k]);
        __syncwarp();
    }
    __syncthreads();
    if (t < RADIX) s_loc[t] = warp_offsets(s_whist, t);
    __syncthreads();
    block_scan(s_loc, RADIX, 0u);
    if (t < RADIX)
        s_delta[t] = (int)offsets[(long long)t * gridDim.x + blockIdx.x]
            - (int)s_loc[t];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (base + tile_row(w, k, lane) >= N) continue;
        const int j = stage_pos(s_whist, s_loc, w,
                                digit_of(key[k], shift), rank[k]);
        s_key[j] = key[k];
        s_idx[j] = idx[k];
    }
    __syncthreads();
    const int n = (int)(N - base < SORT_TILE ? N - base : SORT_TILE);
    for (int j = t; j < n; j += SORT_THREADS) {
        const uint64_t kk = s_key[j];
        const long long o = j + s_delta[digit_of(kk, shift)];
        key_out[o] = kk;
        idx_out[o] = s_idx[j];
    }
}

// out[a][i] = buf[a][perm[i]], column a = blockIdx.y
__global__ void gather_rows(const int* buf, long long N,
                            const unsigned* perm, int* out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const long long a = blockIdx.y;
    out[a * N + i] = buf[a * N + perm[i]];
}

// ---- segments --------------------------------------------------------------

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// x[0..4) = p[0..4): one 16-byte load (p is 16-byte aligned)
__device__ __forceinline__ void load_items(const int* p, int* x) {
    static_assert(SEG_ITEMS == 4, "one int4 load a column");
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// row ``r`` of the lane ``delta`` away (down: higher lanes)
__device__ __forceinline__ SegRow shfl_row(const SegRow& r, int delta,
                                           bool down) {
    auto f = [&](int x) {
        return down ? __shfl_down_sync(FULL, x, delta)
                    : __shfl_up_sync(FULL, x, delta);
    };
    return SegRow{f(r.inv), f(r.g), f(r.p), f(r.k), f(r.s), f(r.v)};
}

// The prefix of tile ``tile``'s starts: warp-wide look-back over the
// status words of the tiles before it, 32 at a time, nearest first; waits
// until none of a window is unpublished, then sums up to the nearest
// inclusive prefix.
__device__ unsigned seg_lookback(const unsigned long long* status,
                                 unsigned tile, int lane) {
    unsigned run = 0;
    for (long long j = (long long)tile - 1;; j -= 32) {
        const long long mine = j - lane;
        unsigned long long s;
        do {
            s = mine >= 0 ? ld_acquire(status + mine) : SEG_PRE;
        } while (__any_sync(FULL, (s >> 32) == 0));
        const unsigned pre = __ballot_sync(FULL, (s >> 32) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        run += __reduce_add_sync(FULL, lane <= stop ? (unsigned)s : 0u);
        if (pre) return run;
    }
}

// Stage STAGE over the sorted table buf: one tile of SEG_TILE rows a
// block (see the note at the head of the file).  Stage 1 writes the unique
// rows into out [4][N] and their stage-2 rows into buf2, stage 2 the
// consensus rows into out [6][N]; the last tile writes the count into
// counts[STAGE - 1].  Dynamic shared memory: the staged output rows, 4
// (stage 1) or 6 (stage 2) ints a row of the tile.
template <int STAGE>
__global__ void __launch_bounds__(SEG_THREADS)
seg_pass(const int* __restrict__ buf, long long N, int mode_sum, int ovr,
         unsigned* counter, unsigned long long* status, int* __restrict__ out,
         int* __restrict__ buf2, int* __restrict__ counts) {
    extern __shared__ int s_stage[];    // [cols][SEG_TILE]
    __shared__ unsigned s_wcnt[SEG_WARPS];
    __shared__ Seg s_wagg[SEG_WARPS];
    __shared__ unsigned s_tile, s_prefix;
    __shared__ int s_tail;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int sum = STAGE == 2 || mode_sum;
    const int idn = seg_identity(sum);
    if (t == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const unsigned tile = s_tile;
    const long long base = (long long)tile * SEG_TILE;
    const long long r0 = base + (long long)t * SEG_ITEMS;

    // the thread's rows, each column once; N is a multiple of 1,024, so a
    // thread has all SEG_ITEMS rows or none.  Rows none of which is ok
    // are read no further (see seg_row).
    SegRow r[SEG_ITEMS];
    int ok = 0;
    if (r0 < N) {
        int x[SEG_ITEMS];
        load_items(buf + r0, x);
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) {
            r[k] = SegRow{x[k], 0, 0, 0, 0, 0};
            ok |= x[k] == 0;
        }
    } else {
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k] = seg_none();
    }
    if (ok) {
        int x[SEG_ITEMS];
        load_items(buf + N + r0, x);
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k].g = x[k];
        load_items(buf + 2 * N + r0, x);
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k].p = x[k];
        load_items(buf + 3 * N + r0, x);
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k].k = r[k].s = x[k];
        if (STAGE == 2) {
            load_items(buf + 6 * N + r0, x);
            UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k].s = x[k];
        }
        load_items(buf + seg_col_v(STAGE) * N + r0, x);
        UNROLL for (int k = 0; k < SEG_ITEMS; ++k) r[k].v = x[k];
    }
    SegRow prev = shfl_row(r[SEG_ITEMS - 1], 1, false);
    SegRow next = shfl_row(r[0], 1, true);
    if (lane == 0)
        prev = r0 > 0 && r0 < N ? seg_row(buf, N, STAGE, r0 - 1) : seg_none();
    if (lane == 31)
        next = r0 + SEG_ITEMS < N ? seg_row(buf, N, STAGE, r0 + SEG_ITEMS)
                                  : seg_none();
    unsigned start, end;
    seg_flags(r, prev, next, start, end);

    // the starts' counts, scanned over the warp; the suffixes' aggregates,
    // scanned from the right over the warp
    const unsigned cnt = __popc(start);
    unsigned x = cnt;
    Seg red[SEG_ITEMS];
    Seg y = seg_suffix(r, end, Seg{idn, 0}, sum, red);
    UNROLL
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned xc = __shfl_up_sync(FULL, x, o);
        const int yv = __shfl_down_sync(FULL, y.v, o);
        const int yf = __shfl_down_sync(FULL, y.f, o);
        if (lane >= o) x += xc;
        if (lane + o < 32 && !y.f) y = Seg{seg_op(sum, y.v, yv), yf};
    }
    if (lane == 31) s_wcnt[w] = x;
    if (lane == 0) s_wagg[w] = y;
    __syncthreads();
    unsigned before = 0, total = 0;
    UNROLL
    for (int i = 0; i < SEG_WARPS; ++i) {
        before += i < w ? s_wcnt[i] : 0u;
        total += s_wcnt[i];
    }
    Seg carry{idn, 0};
    for (int i = SEG_WARPS - 1; i > w; --i)
        carry = seg_join(s_wagg[i], carry, sum);
    const Seg nx{__shfl_down_sync(FULL, y.v, 1),
                 __shfl_down_sync(FULL, y.f, 1)};
    if (lane < 31) carry = seg_join(nx, carry, sum);
    seg_suffix(r, end, carry, sum, red);

    if (w == 0) {
        // publish the tile's count, look back, publish its prefix
        if (lane == 0) st_release(status + tile, (tile ? SEG_AGG : SEG_PRE)
                                                     | total);
        const unsigned pre = tile ? seg_lookback(status, tile, lane) : 0u;
        if (lane == 0) {
            if (tile) st_release(status + tile, SEG_PRE | (pre + total));
            s_prefix = pre;
            if (tile == gridDim.x - 1) counts[STAGE - 1] = (int)(pre + total);
        }
    } else if (w == SEG_WARPS - 1) {
        // the segment at the tile's last row runs on into the next tile:
        // when it starts in this tile, reduce the rest of it, 32 rows a step
        const int cont = __shfl_sync(FULL, !((end >> (SEG_ITEMS - 1)) & 1u),
                                     31);
        int tail = idn;
        if (cont && total) {
            const SegRow& last = r[SEG_ITEMS - 1];  // lane 31's, an ok row
            const SegRow key{0, __shfl_sync(FULL, last.g, 31),
                             __shfl_sync(FULL, last.p, 31),
                             __shfl_sync(FULL, last.k, 31), 0, 0};
            for (long long j0 = base + SEG_TILE;; j0 += 32) {
                const long long j = j0 + lane;
                int v = idn;
                bool in = false;
                if (j < N) {
                    const SegRow q = seg_row(buf, N, STAGE, j);
                    in = seg_same(key, q);
                    v = q.v;
                }
                const unsigned b = __ballot_sync(FULL, in);
                const int n = b == FULL ? 32 : __ffs(~b) - 1;
                if (lane >= n) v = idn;
                tail = seg_op(sum, tail,
                              sum ? (int)__reduce_add_sync(FULL, (unsigned)v)
                                  : __reduce_max_sync(FULL, v));
                if (n < 32) break;
            }
        }
        if (lane == 0) s_tail = tail;
    }
    __syncthreads();

    // stage each start's output row at its rank in the tile, then write
    // the tile's rows out in order
    const unsigned prefix = s_prefix;
    const int tail = s_tail;
    unsigned lr = x - cnt + before;
    UNROLL
    for (int k = 0; k < SEG_ITEMS; ++k) {
        if (!((start >> k) & 1u)) continue;
        const int v = red[k].f ? red[k].v : seg_op(sum, red[k].v, tail);
        int* st = s_stage + lr++;
        st[0] = r[k].g;
        st[SEG_TILE] = r[k].p;
        st[2 * SEG_TILE] = r[k].k;
        st[3 * SEG_TILE] = v;
        if (STAGE == 2) {
            st[4 * SEG_TILE] = r[k].s;
            st[5 * SEG_TILE] = r[k].v;
        }
    }
    __syncthreads();
    // a warp's 32 rows of a column start at a multiple of 32 in it, so
    // each store fills whole 32-byte sectors
    for (int j = t - (int)(prefix & 31u); j < (int)total; j += SEG_THREADS) {
        if (j < 0) continue;
        const int* st = s_stage + j;
        if (STAGE == 1)
            seg_write_unique(out, buf2, N, prefix + j, st[0], st[SEG_TILE],
                             st[2 * SEG_TILE], st[3 * SEG_TILE], ovr);
        else
            seg_write_group(out, N, prefix + j, st[0], st[SEG_TILE],
                            st[2 * SEG_TILE], st[4 * SEG_TILE],
                            st[5 * SEG_TILE], st[3 * SEG_TILE], ovr);
    }
}

// The stage-2 table's rows [n_uniq, N) (n_uniq = counts[0]), 4 rows a
// thread.
__global__ void seg_tail(long long N, const int* counts, int* buf2) {
    const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    const long long n = counts[0];
    if (i >= N || i + 4 <= n) return;
    if (i < n) {
        for (long long k = n; k < i + 4; ++k) seg_write_empty(buf2, N, k);
        return;
    }
    const int4 one{1, 1, 1, 1}, zero{0, 0, 0, 0};
    const int4 idx{(int)i, (int)i + 1, (int)i + 2, (int)i + 3};
    for (int a = 0; a < 9; ++a)
        *reinterpret_cast<int4*>(buf2 + a * N + i) =
            a == 0 ? one : a == 7 ? idx : zero;
}

#endif  // __CUDACC__

}  // namespace

extern "C" long long uvc_dc_sort_scratch(long long N, int A) {
    return scratch_bytes(N, A);
}

extern "C" long long uvc_dc_segments_scratch(long long N) {
    return seg_scratch_bytes(N);
}

#ifdef __CUDACC__

// The key columns' ranges of buf[A][N] into rng[2 * nkeys] (see
// key_ranges), the first step of dc_sort.
extern "C" int uvc_dc_sort_ranges(const void* buf, long long N, int nkeys,
                                  void* rng, void* stream) {
    if (N < 1 || N > MAX_ROWS || nkeys < 1 || nkeys > MAX_COLS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaMemsetAsync(rng, 0xff, 2 * nkeys * sizeof(unsigned),
                                    st);
    if (e != cudaSuccess) return (int)e;
    long long blocks = (N + 2047) / 2048;
    if (blocks > 512) blocks = 512;
    key_ranges<<<dim3((unsigned)blocks, nkeys), 256, 0, st>>>(
        static_cast<const int*>(buf), N, static_cast<unsigned*>(rng));
    return (int)cudaGetLastError();
}

// Sort the rows of buf[A][N] in place by the plan (see above); scratch
// holds uvc_dc_sort_scratch(N, A) bytes.
extern "C" int uvc_dc_sort(void* buf, long long N, int A, const int* plan,
                           int plan_len, void* scratch, void* stream) {
    Word words[MAX_COLS];
    const int nw = (N >= 1 && N <= MAX_ROWS && A >= 1 && A <= MAX_COLS)
        ? parse_plan(plan, plan_len, A, words) : -1;
    if (nw < 0) return (int)cudaErrorInvalidValue;
    if (nw == 0) return (int)cudaGetLastError();  // every key constant
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaFuncSetAttribute(
        digit_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SCATTER_SMEM);
    if (e != cudaSuccess) return (int)e;
    int* b = static_cast<int*>(buf);
    Scratch s = carve(scratch, N);
    const int tiles = (int)sort_tiles(N);
    int passes = 0;
    for (int w = 0; w < nw; ++w) passes += words[w].ndig;
    e = cudaMemsetAsync(s.total, 0, (size_t)RADIX * passes * 4, st);
    if (e != cudaSuccess) return (int)e;
    const unsigned row_blocks = (unsigned)((N + 255) / 256);
    int cur = 0, pass = 0;
    for (int w = 0; w < nw; ++w) {
        pack_word<<<row_blocks, 256, 0, st>>>(b, N, words[w], w == 0,
                                              s.key[cur], s.idx[cur]);
        for (int g = 0; g < words[w].ndig; ++g, ++pass) {
            const int shift = g * RADIX_BITS;
            unsigned* total = s.total + pass * RADIX;
            digit_hist<<<tiles, SORT_THREADS, 0, st>>>(s.key[cur], N, shift,
                                                       s.hist, total);
            digit_scan<<<RADIX, BLOCK, 0, st>>>(s.hist, tiles, total);
            digit_scatter<<<tiles, SORT_THREADS, SCATTER_SMEM, st>>>(
                s.key[cur], s.idx[cur], N, shift, s.hist, s.key[1 - cur],
                s.idx[1 - cur]);
            cur ^= 1;
        }
    }
    gather_rows<<<dim3(row_blocks, A), 256, 0, st>>>(b, N, s.idx[cur],
                                                     s.table);
    e = cudaMemcpyAsync(b, s.table, (size_t)A * N * 4,
                        cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

namespace {

// One stage over the sorted table buf: zero the ``zero`` bytes of the
// call's scratch from the start of stage 1's half (0: none), then
// seg_pass<STAGE> over the tiles with the stage's half (its tile counter
// and status words).  Dynamic shared memory stays under the 48 KB a
// launch may take without opting in.
template <int STAGE>
int seg_launch(const void* buf, long long N, int mode_sum, int ovr,
               void* out, void* buf2, void* counts, void* scratch,
               long long zero, void* stream) {
    if (N < 1024 || N % 1024 || N > MAX_ROWS
        || reinterpret_cast<uintptr_t>(scratch) % 8)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = (STAGE == 1 ? 4 : 6) * SEG_TILE * (int)sizeof(int);
    static_assert(6 * SEG_TILE * sizeof(int) <= 48 * 1024, "opt in");
    char* half = static_cast<char*>(scratch)
                 + (STAGE == 1 ? 0 : seg_stage_bytes(N));
    if (zero) {
        const cudaError_t e = cudaMemsetAsync(
            STAGE == 1 ? scratch : half, 0, (size_t)zero, st);
        if (e != cudaSuccess) return (int)e;
    }
    seg_pass<STAGE><<<(unsigned)seg_tiles(N), SEG_THREADS, smem, st>>>(
        static_cast<const int*>(buf), N, mode_sum, ovr,
        reinterpret_cast<unsigned*>(half),
        reinterpret_cast<unsigned long long*>(half + 8),
        static_cast<int*>(out), static_cast<int*>(buf2),
        static_cast<int*>(counts));
    return (int)cudaGetLastError();
}

}  // namespace

// Stage 1 over the sorted table buf1[6][N]: the unique rows into
// out_u[4][N] (zeroed by the caller), n_uniq into counts[0], and the
// stage-2 table into buf2[9][N].  scratch holds
// uvc_dc_segments_scratch(N) bytes, both stages' halves, which one memset
// zeroes here.
extern "C" int uvc_dc_segments_unique(const void* buf1, long long N,
                                      int mode_sum, int ovr, void* out_u,
                                      void* buf2, void* counts, void* scratch,
                                      void* stream) {
    const int e = seg_launch<1>(buf1, N, mode_sum, ovr, out_u, buf2, counts,
                                scratch, seg_scratch_bytes(N), stream);
    if (e != 0) return e;
    seg_tail<<<(unsigned)(N / 1024), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
        N, static_cast<const int*>(counts), static_cast<int*>(buf2));
    return (int)cudaGetLastError();
}

// Stage 2 over the sorted table buf2[9][N]: the consensus rows
// (group, pos, st, con_sym, con_cnt, tot) into out_c[6][N] (zeroed by the
// caller) and n_grp into counts[1].  scratch holds
// uvc_dc_segments_scratch(N) bytes; its stage-2 half is zeroed here unless
// ``zeroed`` says that stage 1 of the same call zeroed it and no stage 2
// has used it since.
extern "C" int uvc_dc_segments_groups(const void* buf2, long long N, int ovr,
                                      void* out_c, void* counts,
                                      void* scratch, int zeroed,
                                      void* stream) {
    return seg_launch<2>(buf2, N, 1, ovr, out_c, nullptr, counts, scratch,
                         zeroed ? 0 : seg_stage_bytes(N), stream);
}

#else  // ---- host build: the same passes on one thread ---------------------

#include <vector>

extern "C" void uvc_dc_sort_ranges_host(const int* buf, long long N,
                                        int nkeys, unsigned* rng) {
    for (int k = 0; k < nkeys; ++k) {
        unsigned lo = 0xffffffffu, nhi = 0xffffffffu;
        for (long long i = 0; i < N; ++i) {
            const unsigned o = key_ord(buf[k * N + i]);
            lo = o < lo ? o : lo;
            nhi = ~o < nhi ? ~o : nhi;
        }
        rng[2 * k] = lo;
        rng[2 * k + 1] = nhi;
    }
}

namespace {

// digit_scatter on one tile, its warps and lanes run in turn; the lanes of
// a step read their ranks before any commits, as after __syncwarp
void scatter_tile(const Scratch& s, int cur, long long N, int shift,
                  int tiles, int tile) {
    std::vector<unsigned> whist(SORT_WARPS * RADIX, 0), loc(RADIX);
    std::vector<int> delta(RADIX);
    std::vector<uint64_t> s_key(SORT_TILE);
    std::vector<unsigned> s_idx(SORT_TILE), rank(SORT_TILE);
    const long long base = (long long)tile * SORT_TILE;
    for (int w = 0; w < SORT_WARPS; ++w)
        for (int k = 0; k < ITEMS; ++k) {
            unsigned d[32], peers[32];
            for (int l = 0; l < 32; ++l) {
                const long long r = base + tile_row(w, k, l);
                d[l] = r < N ? digit_of(s.key[cur][r], shift) : RADIX;
            }
            for (int l = 0; l < 32; ++l) {  // __match_any_sync
                peers[l] = 0;
                for (int m = 0; m < 32; ++m)
                    if (d[m] == d[l]) peers[l] |= 1u << m;
            }
            for (int l = 0; l < 32; ++l)
                if (d[l] < RADIX)
                    rank[tile_row(w, k, l)] =
                        rank_read(&whist[w * RADIX], d[l], peers[l], l);
            for (int l = 0; l < 32; ++l)
                if (d[l] < RADIX)
                    rank_commit(&whist[w * RADIX], d[l], peers[l], l,
                                rank[tile_row(w, k, l)]);
        }
    unsigned run = 0;  // block_scan over the digits
    for (int d = 0; d < RADIX; ++d) {
        const unsigned c = warp_offsets(whist.data(), d);
        loc[d] = run;
        run += c;
        delta[d] = (int)s.hist[(long long)d * tiles + tile] - (int)loc[d];
    }
    for (int w = 0; w < SORT_WARPS; ++w)
        for (int k = 0; k < ITEMS; ++k)
            for (int l = 0; l < 32; ++l) {
                const int tr = tile_row(w, k, l);
                if (base + tr >= N) continue;
                const uint64_t key = s.key[cur][base + tr];
                const int j = stage_pos(whist.data(), loc.data(), w,
                                        digit_of(key, shift), rank[tr]);
                s_key[j] = key;
                s_idx[j] = s.idx[cur][base + tr];
            }
    const int n = (int)(N - base < SORT_TILE ? N - base : SORT_TILE);
    for (int j = 0; j < n; ++j) {
        const long long o = j + delta[digit_of(s_key[j], shift)];
        s.key[1 - cur][o] = s_key[j];
        s.idx[1 - cur][o] = s_idx[j];
    }
}

}  // namespace

// uvc_dc_sort on the host: 0, or -1 for a plan the sort does not take.
extern "C" int uvc_dc_sort_host(int* buf, long long N, int A,
                                const int* plan, int plan_len) {
    Word words[MAX_COLS];
    const int nw = (N >= 1 && N <= MAX_ROWS && A >= 1 && A <= MAX_COLS)
        ? parse_plan(plan, plan_len, A, words) : -1;
    if (nw <= 0) return nw;
    std::vector<uint64_t> mem((scratch_bytes(N, A) + 7) / 8);
    Scratch s = carve(mem.data(), N);
    const int tiles = (int)sort_tiles(N);
    int cur = 0, pass = 0;
    for (int w = 0; w < nw; ++w) {
        for (long long i = 0; i < N; ++i) {  // pack_word
            const long long row = w == 0 ? i : s.idx[cur][i];
            s.key[cur][i] = pack_key(buf, N, words[w], row);
            if (w == 0) s.idx[cur][i] = (unsigned)i;
        }
        for (int g = 0; g < words[w].ndig; ++g, ++pass) {
            const int shift = g * RADIX_BITS;
            unsigned* total = s.total + pass * RADIX;
            for (int d = 0; d < RADIX; ++d) total[d] = 0;
            for (int tile = 0; tile < tiles; ++tile) {  // digit_hist
                unsigned h[RADIX] = {};
                const long long base = (long long)tile * SORT_TILE;
                for (long long r = base; r < N && r < base + SORT_TILE; ++r)
                    ++h[digit_of(s.key[cur][r], shift)];
                for (int d = 0; d < RADIX; ++d) {
                    s.hist[(long long)d * tiles + tile] = h[d];
                    total[d] += h[d];
                }
            }
            for (int d = 0; d < RADIX; ++d) {  // digit_scan
                unsigned run = 0;
                for (int e = 0; e < d; ++e) run += total[e];
                for (int tile = 0; tile < tiles; ++tile) {
                    unsigned& x = s.hist[(long long)d * tiles + tile];
                    const unsigned c = x;
                    x = run;
                    run += c;
                }
            }
            for (int tile = 0; tile < tiles; ++tile)
                scatter_tile(s, cur, N, shift, tiles, tile);
            cur ^= 1;
        }
    }
    for (int a = 0; a < A; ++a)  // gather_rows, then the copy back
        for (long long i = 0; i < N; ++i)
            s.table[a * N + i] = buf[a * N + s.idx[cur][i]];
    for (long long i = 0; i < (long long)A * N; ++i) buf[i] = s.table[i];
    return 0;
}

// dc_segments' stage on the host, with tiles of ``tile`` rows (a multiple
// of SEG_ITEMS) run in order: a tile's threads in turn (flags, then the
// suffixes' aggregates, joined from the right as the block's scan joins
// them), the walk of a segment past the tile's end, the look-back as a
// running prefix.  Stage 1 also writes buf2's rows beyond n_uniq, as
// seg_tail does.  0, or -1 for arguments the kernels do not take.
extern "C" int uvc_dc_segments_host(int stage, const int* buf, long long N,
                                    int mode_sum, int ovr, int tile, int* out,
                                    int* buf2, int* counts) {
    if ((stage != 1 && stage != 2) || N < 1024 || N % 1024
        || tile < SEG_ITEMS || tile % SEG_ITEMS)
        return -1;
    const int sum = stage == 2 || mode_sum;
    const int idn = seg_identity(sum);
    const int threads = tile / SEG_ITEMS;
    auto row = [&](long long i) {
        return i >= 0 && i < N ? seg_row(buf, N, stage, i) : seg_none();
    };
    std::vector<SegRow> r(tile);
    std::vector<unsigned> start(threads), end(threads);
    std::vector<Seg> agg(threads), red(tile);
    long long prefix = 0;
    for (long long base = 0; base < N; base += tile) {
        unsigned total = 0;
        for (int t = 0; t < threads; ++t) {
            const long long r0 = base + (long long)t * SEG_ITEMS;
            SegRow* rt = &r[t * SEG_ITEMS];
            for (int k = 0; k < SEG_ITEMS; ++k) rt[k] = row(r0 + k);
            seg_flags(rt, row(r0 - 1), row(r0 + SEG_ITEMS), start[t], end[t]);
            total += popc32(start[t]);
            agg[t] = seg_suffix(rt, end[t], Seg{idn, 0}, sum,
                                &red[t * SEG_ITEMS]);
        }
        int tail = idn;
        if (!((end[threads - 1] >> (SEG_ITEMS - 1)) & 1u) && total) {
            const SegRow& last = r[tile - 1];
            for (long long j = base + tile; j < N; ++j) {
                const SegRow q = seg_row(buf, N, stage, j);
                if (!seg_same(last, q)) break;
                tail = seg_op(sum, tail, q.v);
            }
        }
        Seg carry{idn, 0};
        long long u = prefix;
        for (int t = threads - 1; t >= 0; --t) {
            const Seg a = agg[t];
            seg_suffix(&r[t * SEG_ITEMS], end[t], carry, sum,
                       &red[t * SEG_ITEMS]);
            carry = seg_join(a, carry, sum);
        }
        for (int i = 0; i < tile; ++i) {
            if (!((start[i / SEG_ITEMS] >> (i % SEG_ITEMS)) & 1u)) continue;
            const SegRow& q = r[i];
            const int v = red[i].f ? red[i].v : seg_op(sum, red[i].v, tail);
            if (stage == 1)
                seg_write_unique(out, buf2, N, u++, q.g, q.p, q.k, v, ovr);
            else
                seg_write_group(out, N, u++, q.g, q.p, q.k, q.s, q.v, v, ovr);
        }
        prefix += total;
    }
    counts[stage - 1] = (int)prefix;
    if (stage == 1)
        for (long long i = prefix; i < N; ++i) seg_write_empty(buf2, N, i);
    return 0;
}

#endif  // __CUDACC__
