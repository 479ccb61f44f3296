// Two-axis FIR as two dense matrix products on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `kernel_mxu` of the banded-FIR probe
// (scripts/exp_mxu_down.py:47). For a plane P [Qh, Qw, C] and matrices
// Mw [J, Qw] and Mh [I, Qh], all of one dtype (fp32 or bf16), it computes
//   t[q, j, c] = sum_w Mw[j, w] * P[q, w, c]   (exact products, fp32 sums)
//   o[i, j, c] = sum_q Mh[i, q] * t[q, j, c]   (an fp32 contraction over fp32 t)
// into o [I, J, C] in fp32, for any matrices: a banded Mw and Mh make it the
// FIR.
//
// Both products are GEMMs with a small M and K (J or I rows, Qw or Qh deep)
// and a wide N (the channels), run with mma.sync:
// - the first: bf16 P and Mw go straight into m16n8k16 bf16 MMAs; fp32 P and
//   Mw are each split into tf32 hi + lo and take three m16n8k8 tf32 MMAs
//   (hi*hi + hi*lo + lo*hi; the dropped lo*lo is ~2^-22 of the product);
// - the second: t is split into tf32 hi + lo (tf32 alone keeps ~2^-11, a
//   bf16-rounded t 2^-9: neither is the TPU kernel's function); Mh is exact
//   in tf32 when it holds bf16 values (two MMAs), else it is split too (three).
//
// Schedule. A block owns one group of kCg = 8 channels (the MMA's N) and one
// band of at most kBand = 16 columns j of t and o: J is cut into
// ceil(J / 16) bands of equal width (the last may be narrower). Columns of t
// and o partition exactly, so a band needs only Mw's rows of that band and
// gives only o's columns of that band, with nothing recomputed for any
// matrices. The band index is the grid's fastest, so the blocks of one
// channel group run together and share P's rows in L2. A block keeps its
// band's fp32 t, [Qh][band][8], in shared memory between the two products,
// small enough that two or three blocks share an SM: one block's loads
// overlap another's products and stores. A warp takes one row q of P at a
// time for the first product (one m-tile: the band's rows of Mw), and one
// m-tile of Mh with up to kCols columns of t at a time for the second.
//
// P's rows reach the first product through shared memory: each warp keeps a
// ring of two row stages, [column][8 channels], and copies the band's
// columns of row q + 8 into one with cp.async (16-byte channel slices of a
// pixel) while it multiplies row q from the other. bf16 B fragments come
// from the stage with ldmatrix.trans, fp32 ones with conflict-free 32-bit
// loads. Where a pixel's 8 channels are not whole aligned 16-byte slices
// (C % 8 != 0 in bf16, C % 4 != 0 in fp32, the last group of a ragged C, or
// a plane not 16-byte aligned), the warp fills the stage with element loads.
//
// The band's all-zero blocks are skipped. While a matrix is staged, the
// block records for each m-tile the first and last column that holds a
// non-zero entry (a warp reduction per row, then shared-memory atomicMin /
// atomicMax), and both products run over the K steps that hold them only.
// A band fetches only P's columns in that range; the rest of its K steps
// read zeros. Dense matrices run every step; for a finite plane the result
// is the dense product's, since the skipped terms are exact zeros. Unlike
// the TPU kernel's dense products, a non-finite value of P outside a band's
// columns, or under a skipped block of Mh, is not spread into o.
// A warp holds the A fragments of up to kRegK K steps in registers, split
// into tf32 hi and lo once (fp32): for the probe's 12 taps every m-tile's
// range fits, and the inner loops split only P and t.
//
// Bound on the card: at 12 taps the useful work is ~50 FLOP per output
// against 6-8 bytes, so bytes(in + out) / 3.35 TB/s. The tensor cores also
// multiply the zeros inside the non-zero K steps and the split terms, still
// under their rate. wgmma and TMA are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfir_banded.so fir_banded.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"  // mma_tf32, mma_bf16, split, pack_bf16, ldmatrix_x4_trans, cp_async_16

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // resident blocks per SM that the registers must allow
constexpr int kCg = 8;         // channels per block: the MMA's N
constexpr int kBand = 16;      // most columns of t and o per block: one m-tile of Mw
constexpr int kMaxMt = 8;      // m-tiles of Mh: I <= 128
constexpr int kMaxQw = 128;
constexpr int kMaxRows = 128;  // J and I
constexpr int kRegK = 4;       // K steps whose A fragments a warp holds in registers
constexpr int kCols = 4;       // columns of t per task of the second product

template <typename T>
constexpr int kStepK = std::is_same<T, float>::value ? 8 : 16;  // K of the first product's MMA

// Smallest v' >= v with v' % m == r.
constexpr int pad_to(int v, int m, int r) { return v + ((r - v % m) % m + m) % m; }

struct Layout {
    int bands, band;  // J in `bands` bands of `band` <= kBand columns (the last may be narrower)
    int mt;           // m-tiles of Mh (rows zero-padded to 16 mt)
    int kt1, ldw;     // first product: K steps over Qw, Mw pitch (elements)
    int kt2, ldh;     // second: K steps over Qh, Mh pitch (floats)
    int pitch;        // t's row pitch (floats); a row q holds [band][kCg]
    int rows;         // columns of P a ring stage holds, [rows][kCg]
    size_t t_bytes, mw_bytes, m_bytes;
};

struct Args {
    int qh, qw, c, j, i;
    Layout l;
};

// Row pitches: a fragment load reads rows gid = 0..7 at words tig = 0..3, so a
// pitch of 4 (mod 8) 32-bit words puts the 8 rows on distinct groups of 4
// banks; t's pitch of 8 (mod 32) words does the same for its rows tig.
template <typename T>
Layout layout(int qh, int qw, int j, int i) {
    Layout l;
    l.bands = (j + kBand - 1) / kBand;
    l.band = (j + l.bands - 1) / l.bands;
    l.mt = (i + 15) / 16;
    l.kt1 = (qw + kStepK<T> - 1) / kStepK<T>;
    l.ldw = sizeof(T) == 4 ? pad_to(l.kt1 * 8, 8, 4) : pad_to(l.kt1 * 16, 16, 8);
    l.kt2 = (qh + 7) / 8;
    l.ldh = pad_to(l.kt2 * 8, 8, 4);
    l.pitch = pad_to(l.band * kCg, 32, 8);
    // fp32 reads are guarded at Qw; ldmatrix reads two whole K steps of 16
    // from the first, so bf16 stages hold one step more.
    l.rows = sizeof(T) == 4 ? qw : l.kt1 * 16 + 16;
    l.t_bytes = sizeof(float) * size_t(qh) * l.pitch;
    l.mw_bytes = sizeof(T) * 16 * size_t(l.ldw);
    const size_t ring = sizeof(T) * size_t(kWarps) * 2 * l.rows * kCg;
    const size_t mh = sizeof(float) * size_t(l.mt) * 16 * l.ldh;
    l.m_bytes = l.mw_bytes + ring > mh ? l.mw_bytes + ring : mh;
    return l;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Stages the rows r0 .. r0 + rows - 1 of matrix m [*, cols] as nt * 16 rows of
// pitch ld at s, zero-padded to `width` columns: a warp per row,
// its lanes along the row, the loads of kBatch rows (128 columns each) in
// flight at once. Records each m-tile's first and last column with a
// non-zero entry in lo[mt] / hi[mt], which must hold INT_MAX / -1 before (NaN
// counts as non-zero): one atomic per row, after a warp reduction.
template <typename U, typename T>
__device__ __forceinline__ void stage_matrix(U* s, const T* m, int r0, int rows, int cols,
                                             int nt, int ld, int width, int* lo, int* hi) {
    constexpr int kBatch = 4;
    const int lane = threadIdx.x & 31;
    for (int rb = threadIdx.x >> 5; rb < nt * 16; rb += kWarps * kBatch) {
        int first[kBatch], last[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            first[b] = 0x7fffffff;
            last[b] = -1;
        }
        for (int k0 = 0; k0 < width; k0 += 128) {
            float v[kBatch][4];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const int r = rb + b * kWarps;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int k = k0 + lane + 32 * u;
                    v[b][u] = r < rows && k < cols ? to_f32(m[size_t(r0 + r) * cols + k]) : 0.f;
                }
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const int r = rb + b * kWarps;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int k = k0 + lane + 32 * u;
                    if (r >= nt * 16 || k >= width) continue;
                    s[r * ld + k] = from_f32<U>(v[b][u]);
                    if (!(v[b][u] == 0.f)) {
                        first[b] = min(first[b], k);
                        last[b] = max(last[b], k);
                    }
                }
            }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int r = rb + b * kWarps;
            const int f = __reduce_min_sync(0xffffffffu, first[b]);
            const int g = __reduce_max_sync(0xffffffffu, last[b]);
            if (lane == 0 && g >= 0) {
                atomicMin(lo + r / 16, f);
                atomicMax(hi + r / 16, g);
            }
        }
    }
}

// The A fragments of K steps ks0 .. min(ks0 + kRegK - 1, ks_hi) of the 16-row
// tile at `a` (pitch ld): fp32 as tf32 hi (and lo, where kSplit), rows gid,
// gid + 8 and columns tig, tig + 4 of each 16x8 tile; bf16 as pairs, columns
// 2 tig (+1), 2 tig + 8 (+9) of each 16x16 tile.
template <bool kSplit, typename T>
__device__ __forceinline__ void load_a(const T* a, int ld, int ks0, int ks_hi, int gid, int tig,
                                       uint32_t (&ah)[kRegK][4], uint32_t (&al)[kRegK][4]) {
#pragma unroll
    for (int kk = 0; kk < kRegK; ++kk) {
        if (ks0 + kk > ks_hi) break;
        const T* r = a + (ks0 + kk) * kStepK<T> + gid * ld;
        if constexpr (std::is_same<T, float>::value) {
            const float v[4] = {r[tig], r[8 * ld + tig], r[tig + 4], r[8 * ld + tig + 4]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if constexpr (kSplit) {
                    split(v[e], ah[kk][e], al[kk][e]);
                } else {
                    ah[kk][e] = __float_as_uint(v[e]);  // already a tf32 value
                }
            }
        } else {
            ah[kk][0] = *reinterpret_cast<const uint32_t*>(r + 2 * tig);
            ah[kk][1] = *reinterpret_cast<const uint32_t*>(r + 8 * ld + 2 * tig);
            ah[kk][2] = *reinterpret_cast<const uint32_t*>(r + 2 * tig + 8);
            ah[kk][3] = *reinterpret_cast<const uint32_t*>(r + 8 * ld + 2 * tig + 8);
        }
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most n of this thread's latest cp.async groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// The K steps of width kk that hold columns first .. last: (1, 0), no step,
// where last < 0.
__device__ __forceinline__ int2 k_steps(int first, int last, int kk) {
    return last < 0 ? make_int2(1, 0) : make_int2(first / kk, last / kk);
}

// acc += A * B for one 8-wide K step with the fp32 B fragment (b0, b1) split
// into tf32 hi + lo: three MMAs where A is split too, else two.
template <bool kSplitA>
__device__ __forceinline__ void tf32_step(float (&acc)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0, float b1) {
    uint32_t bh[2], bl[2];
    split(b0, bh[0], bl[0]);
    split(b1, bh[1], bl[1]);
    if constexpr (kSplitA) mma_tf32(acc, al, bh);
    mma_tf32(acc, ah, bl);
    mma_tf32(acc, ah, bh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fir_banded_kernel(const T* __restrict__ p, const T* __restrict__ mw,
                  const T* __restrict__ mh, float* __restrict__ out,
                  const __grid_constant__ Args a) {
    constexpr bool kF32 = std::is_same<T, float>::value;
    constexpr int kK = kStepK<T>;
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout& l = a.l;
    float* t_s = reinterpret_cast<float*>(smem);                 // [qh][pitch]
    T* mw_s = reinterpret_cast<T*>(smem + l.t_bytes);            // [16][ldw]
    T* ring_s = reinterpret_cast<T*>(smem + l.t_bytes + l.mw_bytes);  // [warp][2][rows][kCg]
    float* mh_s = reinterpret_cast<float*>(smem + l.t_bytes);    // [mt * 16][ldh], mw_s's space
    // First and last non-zero column of Mw's band tile, then of Mh's m-tiles.
    __shared__ int nz_lo[1 + kMaxMt], nz_hi[1 + kMaxMt];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int band = blockIdx.x % l.bands, c0 = blockIdx.x / l.bands * kCg;
    const int j0 = band * l.band, nj = min(l.band, a.j - j0);

    if (threadIdx.x <= l.mt) {
        nz_lo[threadIdx.x] = 0x7fffffff;
        nz_hi[threadIdx.x] = -1;
    }
    __syncthreads();
    // 0. The band's rows of Mw into shared memory, zero-padded to a whole tile.
    stage_matrix(mw_s, mw, j0, nj, a.qw, 1, l.ldw, l.kt1 * kK, nz_lo, nz_hi);
    __syncthreads();

    // 1. t[q] = Mw . P[q] over the band's K range: a warp per row q, from its
    //    ring stage; lane (gid, tig) takes channel c0 + gid at K indices of tig.
    {
        const int2 ks = k_steps(nz_lo[0], nz_hi[0], kK);
        const int lo = ks.x, hi = ks.y;
        const bool resident = hi - lo < kRegK;
        uint32_t ah[kRegK][4], al[kRegK][4];
        if (resident) load_a<true>(mw_s, l.ldw, lo, hi, gid, tig, ah, al);
        // The ring starts zeroed: a stage's columns outside the band's non-zero
        // columns w0 .. w1 - 1, the only ones fetched, multiply Mw's zeros.
        T* ring = ring_s + size_t(warp) * 2 * l.rows * kCg;
        for (int idx = lane; idx < 2 * l.rows * kCg * int(sizeof(T)) / 16; idx += 32) {
            reinterpret_cast<uint4*>(ring)[idx] = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
        // The band's columns of P, and whether they come as whole aligned slices.
        const int w0 = hi < lo ? 0 : nz_lo[0], w1 = hi < lo ? 0 : nz_hi[0] + 1;
        constexpr int kPer = 16 / int(sizeof(T));  // elements of a 16-byte slice
        const bool whole = (reinterpret_cast<uintptr_t>(p) & 15) == 0 && a.c % kPer == 0 &&
                           c0 + kCg <= a.c;
        auto fetch = [&](int q, T* st) {  // P[q, w0:w1, c0:c0 + 8] into st [rows][kCg]
            const T* src = p + size_t(q) * a.qw * a.c + c0;
            if (whole) {
                for (int idx = lane; idx < (w1 - w0) * (kCg / kPer); idx += 32) {
                    const int w = w0 + idx / (kCg / kPer), e = idx % (kCg / kPer) * kPer;
                    cp_async_16(st + w * kCg + e, src + size_t(w) * a.c + e);
                }
            } else {
                for (int idx = lane; idx < (w1 - w0) * kCg; idx += 32) {
                    const int w = w0 + idx / kCg, e = idx % kCg;
                    st[w * kCg + e] = c0 + e < a.c ? src[size_t(w) * a.c + e] : from_f32<T>(0.f);
                }
            }
            cp_async_commit();
        };
        if (warp < a.qh) fetch(warp, ring);
        for (int q = warp, n = 0; q < a.qh; q += kWarps, ++n) {
            const T* st = ring + (n & 1) * l.rows * kCg;
            if (q + kWarps < a.qh) {
                fetch(q + kWarps, ring + ((n + 1) & 1) * l.rows * kCg);
            } else {
                cp_async_commit();
            }
            cp_async_wait<1>();  // row q has landed
            __syncwarp();
            float acc[4] = {};
            for (int ks0 = lo; ks0 <= hi; ks0 += kRegK) {
                if (!resident) load_a<true>(mw_s, l.ldw, ks0, hi, gid, tig, ah, al);
                if constexpr (kF32) {
#pragma unroll
                    for (int kk = 0; kk < kRegK; ++kk) {
                        if (ks0 + kk > hi) break;
                        const int k = (ks0 + kk) * 8 + tig;
                        const float b0 = k < a.qw ? st[k * kCg + gid] : 0.f;
                        const float b1 = k + 4 < a.qw ? st[(k + 4) * kCg + gid] : 0.f;
                        tf32_step<true>(acc, ah[kk], al[kk], b0, b1);
                    }
                } else {
                    // Two K steps of 16 per ldmatrix: rows k .. k + 31 of the stage.
#pragma unroll
                    for (int kk = 0; kk < kRegK; kk += 2) {
                        if (ks0 + kk > hi) break;
                        uint32_t b[4];
                        ldmatrix_x4_trans(b, st + ((ks0 + kk) * 16 + lane) * kCg);
                        const uint32_t b01[2] = {b[0], b[1]}, b23[2] = {b[2], b[3]};
                        mma_bf16(acc, ah[kk], b01);
                        if (ks0 + kk + 1 <= hi) mma_bf16(acc, ah[kk + 1], b23);
                    }
                }
            }
            __syncwarp();  // the stage is read: the next fetch may refill it
            // The band's rows j = gid, gid + 8, channels 2 tig, 2 tig + 1.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = gid + 8 * h;
                if (j < nj) {
                    *reinterpret_cast<float2*>(t_s + q * l.pitch + j * kCg + 2 * tig) =
                        make_float2(acc[2 * h], acc[2 * h + 1]);
                }
            }
        }
        cp_async_wait<0>();
    }
    __syncthreads();  // the band's t is whole; Mw is no longer needed

    // 2. Mh into shared memory as fp32 (exact for bf16), zero-padded.
    stage_matrix(mh_s, mh, 0, a.i, a.qh, l.mt, l.ldh, l.kt2 * 8, nz_lo + 1, nz_hi + 1);
    __syncthreads();

    // 3. o = Mh . t: a warp per task, one m-tile of Mh and up to kCols columns
    //    of the band's t (8 channels each, the N tile), over the m-tile's K
    //    range. Tasks run column chunk by column chunk, so the narrow last
    //    chunk comes last.
    const bool even_c = (a.c & 1) == 0;
    const int chunks = (nj + kCols - 1) / kCols;
    for (int task = warp; task < l.mt * chunks; task += kWarps) {
        const int jc = task / l.mt * kCols, mt = task % l.mt;
        const int cols = min(kCols, nj - jc);
        const int2 ks = k_steps(nz_lo[1 + mt], nz_hi[1 + mt], 8);
        const int lo = ks.x, hi = ks.y;
        const float* a_tile = mh_s + mt * 16 * l.ldh;
        float acc[kCols][4] = {};
        for (int ks0 = lo; ks0 <= hi; ks0 += kRegK) {
            uint32_t ah[kRegK][4], al[kRegK][4];
            load_a<kF32>(a_tile, l.ldh, ks0, hi, gid, tig, ah, al);
#pragma unroll
            for (int kk = 0; kk < kRegK; ++kk) {
                if (ks0 + kk > hi) break;
                const int k = (ks0 + kk) * 8 + tig;
#pragma unroll
                for (int col = 0; col < kCols; ++col) {
                    if (col >= cols) break;
                    const float* tcol = t_s + (jc + col) * kCg + gid;
                    const float b0 = k < a.qh ? tcol[k * l.pitch] : 0.f;
                    const float b1 = k + 4 < a.qh ? tcol[(k + 4) * l.pitch] : 0.f;
                    tf32_step<kF32>(acc[col], ah[kk], al[kk], b0, b1);
                }
            }
        }
        // Rows i = 16 mt + gid (+ 8), columns j0 + jc + col, channels 2 tig (+ 1).
#pragma unroll
        for (int col = 0; col < kCols; ++col) {
            if (col >= cols) break;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = mt * 16 + gid + 8 * h, ch = c0 + 2 * tig;
                if (i >= a.i || ch >= a.c) continue;
                float* dst = out + (size_t(i) * a.j + j0 + jc + col) * a.c + ch;
                if (even_c) {  // ch + 1 < c, and dst is 8-byte aligned
                    *reinterpret_cast<float2*>(dst) =
                        make_float2(acc[col][2 * h], acc[col][2 * h + 1]);
                } else {
                    dst[0] = acc[col][2 * h];
                    if (ch + 1 < a.c) dst[1] = acc[col][2 * h + 1];
                }
            }
        }
    }
}

size_t smem_bytes(const Layout& l) { return l.t_bytes + l.m_bytes; }

template <typename T>
int launch(const void* p, const void* mw, const void* mh, void* out, const Args& a,
           cudaStream_t stream) {
    auto kernel = fir_banded_kernel<T>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes(a.l)));
    if (err != cudaSuccess) return int(err);
    const unsigned groups = unsigned((a.c + kCg - 1) / kCg);
    kernel<<<dim3(groups * unsigned(a.l.bands)), kThreads, smem_bytes(a.l), stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(mw), static_cast<const T*>(mh),
        static_cast<float*>(out), a);
    return int(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(const Args& a) {
    auto kernel = fir_banded_kernel<T>;
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem_bytes(a.l)));
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                            smem_bytes(a.l));
    }
    return err == cudaSuccess ? n : -int(err);
}

bool valid(int qh, int qw, int c, int j, int i, int dtype) {
    return qh >= 1 && qw >= 1 && qw <= kMaxQw && c >= 1 && j >= 1 && i >= 1 &&
           j <= kMaxRows && i <= kMaxRows && (dtype == 0 || dtype == 1);
}

Args args(int qh, int qw, int c, int j, int i, int dtype) {
    return Args{qh, qw, c, j, i,
                dtype == 0 ? layout<float>(qh, qw, j, i) : layout<__nv_bfloat16>(qh, qw, j, i)};
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, dtype 0 = float32, 1 = bfloat16.
size_t sg3_fir_banded_smem_bytes(int qh, int qw, int j, int i, int dtype) {
    return smem_bytes(args(qh, qw, 1, j, i, dtype).l);
}

// Blocks of the launch for these shapes that the card keeps resident on one
// SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError_t; shapes the launch refuses give -cudaErrorInvalidValue.
int sg3_fir_banded_blocks_per_sm(int qh, int qw, int j, int i, int dtype) {
    if (!valid(qh, qw, 1, j, i, dtype)) return -int(cudaErrorInvalidValue);
    const Args a = args(qh, qw, 1, j, i, dtype);
    return dtype == 0 ? blocks_per_sm<float>(a) : blocks_per_sm<__nv_bfloat16>(a);
}

// p [qh, qw, c], mw [j, qw], mh [i, qh]: contiguous device tensors of one
// dtype, 0 = float32, 1 = bfloat16, with qw, j, i <= 128. out: float32
// [i, j, c] on the device. Returns the cudaError_t of the launch (0 on
// success).
int sg3_fir_banded(const void* p, const void* mw, const void* mh, void* out, int dtype,
                   int qh, int qw, int c, int j, int i, void* stream) {
    if (!valid(qh, qw, c, j, i, dtype)) return int(cudaErrorInvalidValue);
    const Args a = args(qh, qw, c, j, i, dtype);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch<float>(p, mw, mh, out, a, s)
                      : launch<__nv_bfloat16>(p, mw, mh, out, a, s);
}

}  // extern "C"
