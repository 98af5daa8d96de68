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
// dc_segments (uvc_dc_segments_unique, uvc_dc_segments_groups): over
// sorted rows, a segment starts where the key columns change; a per-block
// count of the starts (__syncthreads_count), a scan of the block counts in
// one block, then each block ranks its starts (warp ballots) and the
// thread at each start walks its segment, which is contiguous after the
// sort, to reduce it.  Integer work only, so the results are exact; sums
// wrap in int32 as the JAX program's do.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;     // threads of a segment or scan block
constexpr int MAX_COLS = 9;     // widest table: the stage-2 sort

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

// Stage-1 rows: columns (inval, g, p, s, idx, v); a row is ok when inval is
// 0, and a segment is a run of ok rows with equal (g, p, s).
// Stage-2 rows: columns (c_inv, g, p, st, cls, negv, s, idx, v); a group is
// a run of ok rows with equal (g, p, st).
__device__ __forceinline__ bool seg_start(const int* buf, long long N,
                                          long long i) {
    if (buf[i] != 0) return false;               // not ok
    if (i == 0 || buf[i - 1] != 0) return true;  // first ok row
    for (int a = 1; a <= 3; ++a)                 // (g, p, s) or (g, p, st)
        if (buf[a * N + i] != buf[a * N + i - 1]) return true;
    return false;
}

__device__ __forceinline__ bool same_key(const int* buf, long long N,
                                         long long i, long long j) {
    if (buf[j] != 0) return false;
    for (int a = 1; a <= 3; ++a)
        if (buf[a * N + j] != buf[a * N + i]) return false;
    return true;
}

// blocks[b] = number of segment starts in block b
__global__ void __launch_bounds__(BLOCK)
seg_count(const int* buf, long long N, int* blocks) {
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    const int n = __syncthreads_count(seg_start(buf, N, i));
    if (threadIdx.x == 0) blocks[blockIdx.x] = n;
}

// exclusive scan of blocks[0..nb) in place, total into *total (one block)
__global__ void __launch_bounds__(BLOCK)
seg_scan(int* blocks, int nb, int* total) {
    const int sum = block_scan(blocks, nb, 0);
    if (threadIdx.x == 0) *total = sum;
}

// this thread's rank among the block's segment starts, given its flag
__device__ __forceinline__ int block_rank(bool flag) {
    __shared__ int warp_cnt[BLOCK / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned ball = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_cnt[w];
    return before + __popc(ball & ((1u << lane) - 1u));
}

// stage 1: each unique (g, p, s) row with its max or sum of v, at its rank
__global__ void __launch_bounds__(BLOCK)
seg_unique(const int* buf, long long N, int mode_sum, const int* blocks,
           int* out_u) {
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    const bool flag = seg_start(buf, N, i);
    const long long u = blocks[blockIdx.x] + block_rank(flag);
    if (!flag) return;
    const int* v = buf + 5 * N;
    int red = v[i];
    for (long long j = i + 1; j < N && same_key(buf, N, i, j); ++j)
        red = mode_sum ? (int)((unsigned)red + (unsigned)v[j])
                       : (v[j] > red ? v[j] : red);
    out_u[u] = buf[1 * N + i];
    out_u[N + u] = buf[2 * N + i];
    out_u[2 * N + u] = buf[3 * N + i];
    out_u[3 * N + u] = red;
}

// the stage-2 sort's table from the unique rows (zeros beyond n_uniq)
__global__ void keys2(const int* out_u, long long N, int ovr,
                      const int* counts, int* buf2) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const bool uvalid = i < counts[0];
    const int g = out_u[i], p = out_u[N + i], s = out_u[2 * N + i];
    const int v = out_u[3 * N + i];
    const int st = s >= 6;
    const bool cvalid = uvalid && v > 0;
    buf2[i] = !cvalid;
    buf2[N + i] = g;
    buf2[2 * N + i] = p;
    buf2[3 * N + i] = st;
    buf2[4 * N + i] = (ovr && s == 6 && st == 1) ? 1 : 0;  // LINK_M
    buf2[5 * N + i] = (int)(0u - (unsigned)v);              // -v, wrapping
    buf2[6 * N + i] = s;
    buf2[7 * N + i] = (int)i;
    buf2[8 * N + i] = v;
}

// stage 2: each group's first row (the consensus) and its total
__global__ void __launch_bounds__(BLOCK)
seg_groups(const int* buf, long long N, int ovr, const int* blocks,
           int* out_c) {
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    const bool flag = seg_start(buf, N, i);
    const long long gi = blocks[blockIdx.x] + block_rank(flag);
    if (!flag) return;
    const int* v = buf + 8 * N;
    unsigned tot = (unsigned)v[i];
    for (long long j = i + 1; j < N && same_key(buf, N, i, j); ++j)
        tot += (unsigned)v[j];
    const int st = buf[3 * N + i];
    out_c[gi] = buf[N + i];                 // group
    out_c[N + gi] = buf[2 * N + i];         // pos
    out_c[2 * N + gi] = st;                 // symbol type
    out_c[3 * N + gi] = buf[6 * N + i];     // consensus symbol
    out_c[4 * N + gi] = v[i];               // its count
    out_c[5 * N + gi] = (ovr && st == 1) ? v[i] : (int)tot;
}

#endif  // __CUDACC__

}  // namespace

extern "C" long long uvc_dc_sort_scratch(long long N, int A) {
    return scratch_bytes(N, A);
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

// Stage 1 over the sorted table buf1[6][N]: the unique rows into
// out_u[4][N] (zeroed by the caller), n_uniq into counts[0], and the
// stage-2 table into buf2[9][N].  scratch holds N / 1024 ints.
extern "C" int uvc_dc_segments_unique(const void* buf1, long long N,
                                      int mode_sum, int ovr, void* out_u,
                                      void* buf2, void* counts, void* scratch,
                                      void* stream) {
    if (N < BLOCK || N % BLOCK) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* b = static_cast<const int*>(buf1);
    int* blocks = static_cast<int*>(scratch);
    int* cnt = static_cast<int*>(counts);
    const int nb = (int)(N / BLOCK);
    seg_count<<<nb, BLOCK, 0, st>>>(b, N, blocks);
    seg_scan<<<1, BLOCK, 0, st>>>(blocks, nb, cnt);
    seg_unique<<<nb, BLOCK, 0, st>>>(b, N, mode_sum, blocks,
                                     static_cast<int*>(out_u));
    keys2<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(
        static_cast<const int*>(out_u), N, ovr, cnt, static_cast<int*>(buf2));
    return (int)cudaGetLastError();
}

// Stage 2 over the sorted table buf2[9][N]: the consensus rows
// (group, pos, st, con_sym, con_cnt, tot) into out_c[6][N] (zeroed by the
// caller) and n_grp into counts[1].  scratch holds N / 1024 ints.
extern "C" int uvc_dc_segments_groups(const void* buf2, long long N, int ovr,
                                      void* out_c, void* counts,
                                      void* scratch, void* stream) {
    if (N < BLOCK || N % BLOCK) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* b = static_cast<const int*>(buf2);
    int* blocks = static_cast<int*>(scratch);
    const int nb = (int)(N / BLOCK);
    seg_count<<<nb, BLOCK, 0, st>>>(b, N, blocks);
    seg_scan<<<1, BLOCK, 0, st>>>(blocks, nb, static_cast<int*>(counts) + 1);
    seg_groups<<<nb, BLOCK, 0, st>>>(b, N, ovr, blocks,
                                     static_cast<int*>(out_c));
    return (int)cudaGetLastError();
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

#endif  // __CUDACC__
