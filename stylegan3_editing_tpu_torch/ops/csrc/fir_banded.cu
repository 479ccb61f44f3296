// Two-axis FIR as two dense matrix products on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `kernel_mxu` of the banded-FIR probe
// (scripts/exp_mxu_down.py:47). For a plane P [Qh, Qw, C] and matrices
// Mw [J, Qw] and Mh [I, Qh], all of one dtype (fp32 or bf16), it computes
//   t[q, j, c] = sum_w Mw[j, w] * P[q, w, c]   (exact products, fp32 sums)
//   o[i, j, c] = sum_q Mh[i, q] * t[q, j, c]   (an fp32 contraction over fp32 t)
// into o [I, J, C] in fp32, for any matrices: a banded Mw and Mh make it the
// FIR, but nothing here relies on the band.
//
// Both products are GEMMs with a small M and K (J or I rows, Qw or Qh deep)
// and a wide N (the channels), run with mma.sync:
// - the first: bf16 P and Mw go straight into m16n8k16 bf16 MMAs; fp32 P and
//   Mw are each split into tf32 hi + lo and take three m16n8k8 tf32 MMAs
//   (hi*hi + hi*lo + lo*hi; the dropped lo*lo is ~2^-22 of the product);
// - the second: t is split into tf32 hi + lo (tf32 alone keeps ~2^-11, a
//   bf16-rounded t 2^-9: neither is the TPU kernel's function); Mh is exact
//   in tf32 when it holds bf16 values (two MMAs), else it is split too (three).
// One block owns one group of kCg = 8 channels (the MMA's N). The group's
// whole fp32 t, [Qh][J][8], stays in shared memory between the two products
// (158 KB at the probe's 76 x 76 -> 65 x 65), so P is read and o written
// once; one block of 16 warps fills an SM. A warp takes one row q of P at a
// time for the first product, its B fragments loaded from device memory into
// registers up front, and one column j of t at a time for the second. The
// number of 16-row m-tiles, MT (up to 8: J, I <= 128), is a template
// parameter, so a warp's MT accumulator chains sit in one basic block and
// their MMAs interleave. The matrices sit in shared memory, zero-padded to
// the MMA tiles, with row pitches that keep a warp's fragment loads free of
// bank conflicts.
//
// Bound on the card: at 12 taps the useful work is ~50 FLOP per output
// against 6-8 bytes, so bytes(in + out) / 3.35 TB/s. The tensor cores also
// multiply the band's zeros (the matrices are dense) and the split terms, ~8x
// the useful work per split, still under their rate. wgmma, TMA and skipping
// the band's zero blocks are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfir_banded.so fir_banded.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"  // mma_tf32, mma_bf16, split, pack_bf16

namespace {

constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kCg = 8;         // channels per block: the MMA's N
constexpr int kMaxMt = 8;      // m-tiles of 16 rows: J, I <= 128
constexpr int kMaxQw = 128;    // a row's B fragments of the first product sit in registers

template <typename T>
constexpr int kStepK = std::is_same<T, float>::value ? 8 : 16;  // K of the first product's MMA

// Smallest v' >= v with v' % m == r.
constexpr int pad_to(int v, int m, int r) { return v + ((r - v % m) % m + m) % m; }

struct Layout {
    int mt;        // m-tiles of both matrices (rows zero-padded to 16 mt)
    int kt1, ldw;  // first product: K steps over Qw, Mw pitch (elements)
    int kt2, ldh;  // second: K steps over Qh, Mh pitch (floats)
    int pitch;     // t's row pitch (floats); a row q holds [J][kCg]
    size_t t_bytes, m_bytes;
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
    l.mt = (j > i ? j + 15 : i + 15) / 16;
    l.kt1 = (qw + kStepK<T> - 1) / kStepK<T>;
    l.ldw = sizeof(T) == 4 ? pad_to(l.kt1 * 8, 8, 4) : pad_to(l.kt1 * 16, 16, 8);
    l.kt2 = (qh + 7) / 8;
    l.ldh = pad_to(l.kt2 * 8, 8, 4);
    l.pitch = pad_to(j * kCg, 32, 8);
    l.t_bytes = sizeof(float) * size_t(qh) * l.pitch;
    const size_t mw = sizeof(T) * size_t(l.mt) * 16 * l.ldw;
    const size_t mh = sizeof(float) * size_t(l.mt) * 16 * l.ldh;
    l.m_bytes = mw > mh ? mw : mh;
    return l;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// The A fragment of a 16x8 tf32 tile whose top-left element is at `a` (fp32
// rows of pitch ld): rows gid, gid + 8; columns tig, tig + 4.
__device__ __forceinline__ void load_a(const float* a, int ld, int gid, int tig,
                                       float (&v)[4]) {
    const float* r = a + gid * ld + tig;
    v[0] = r[0];
    v[1] = r[8 * ld];
    v[2] = r[4];
    v[3] = r[8 * ld + 4];
}

// acc[mt] (rows 16 mt .. 16 mt + 15 of the output) += A * B for the 8-wide
// K step whose B fragment is (b0, b1), with A the fp32 matrix at `a` (pitch
// ld, already offset to the K step); A split in three MMAs unless it is exact
// in tf32.
template <bool kSplitA, int MT>
__device__ __forceinline__ void tf32_step(float (&acc)[MT][4], const float* a, int ld,
                                          int gid, int tig, float b0, float b1) {
    uint32_t bh[2], bl[2];
    split(b0, bh[0], bl[0]);
    split(b1, bh[1], bl[1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        float av[4];
        load_a(a + mt * 16 * ld, ld, gid, tig, av);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (kSplitA) {
                split(av[e], ah[e], al[e]);
            } else {
                ah[e] = __float_as_uint(av[e]);  // already a tf32 value
            }
        }
        if constexpr (kSplitA) mma_tf32(acc[mt], al, bh);
        mma_tf32(acc[mt], ah, bl);
        mma_tf32(acc[mt], ah, bh);
    }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
fir_banded_kernel(const T* __restrict__ p, const T* __restrict__ mw,
                  const T* __restrict__ mh, float* __restrict__ out,
                  const __grid_constant__ Args a) {
    constexpr bool kF32 = std::is_same<T, float>::value;
    constexpr int kK = kStepK<T>, kMaxKt = kMaxQw / kK;
    extern __shared__ __align__(16) unsigned char smem[];
    float* t_s = reinterpret_cast<float*>(smem);                 // [qh][pitch]
    T* mw_s = reinterpret_cast<T*>(smem + a.l.t_bytes);          // [MT * 16][ldw]
    float* mh_s = reinterpret_cast<float*>(smem + a.l.t_bytes);  // [MT * 16][ldh], mw_s's space
    const Layout& l = a.l;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int c0 = blockIdx.x * kCg;

    // 0. Mw into shared memory, zero-padded to whole tiles.
    {
        const int rows = MT * 16, cols = l.kt1 * kK;
        for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
            const int r = idx / cols, k = idx - r * cols;
            mw_s[r * l.ldw + k] =
                r < a.j && k < a.qw ? mw[size_t(r) * a.qw + k] : from_f32<T>(0.f);
        }
    }
    __syncthreads();

    // 1. t[q] = Mw . P[q]: a warp per row q; lane (gid, tig) loads the B
    //    elements of channel c0 + gid at K indices of tig.
    const bool c_ok = c0 + gid < a.c;
    for (int q = warp; q < a.qh; q += kWarps) {
        const T* prow = p + size_t(q) * a.qw * a.c + c0 + gid;
        auto ld_p = [&](int k) {
            return c_ok && k < a.qw ? prow[size_t(k) * a.c] : from_f32<T>(0.f);
        };
        T bv[kMaxKt][4];  // fp32: K indices tig, tig + 4; bf16: 2 tig + {0, 1, 8, 9}
#pragma unroll
        for (int ks = 0; ks < kMaxKt; ++ks) {
            if (ks >= l.kt1) break;
            const int k = ks * kK;
            if constexpr (kF32) {
                bv[ks][0] = ld_p(k + tig);
                bv[ks][1] = ld_p(k + tig + 4);
            } else {
                bv[ks][0] = ld_p(k + 2 * tig);
                bv[ks][1] = ld_p(k + 2 * tig + 1);
                bv[ks][2] = ld_p(k + 2 * tig + 8);
                bv[ks][3] = ld_p(k + 2 * tig + 9);
            }
        }
        float acc[MT][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxKt; ++ks) {
            if (ks >= l.kt1) break;
            const T* a_tile = mw_s + ks * kK;
            if constexpr (kF32) {
                tf32_step<true>(acc, a_tile, l.ldw, gid, tig, bv[ks][0], bv[ks][1]);
            } else {
                const uint32_t b[2] = {pack_bf16(bv[ks][0], bv[ks][1]),
                                       pack_bf16(bv[ks][2], bv[ks][3])};
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const T* r = a_tile + (mt * 16 + gid) * l.ldw + 2 * tig;
                    const uint32_t av[4] = {
                        *reinterpret_cast<const uint32_t*>(r),
                        *reinterpret_cast<const uint32_t*>(r + 8 * l.ldw),
                        *reinterpret_cast<const uint32_t*>(r + 8),
                        *reinterpret_cast<const uint32_t*>(r + 8 * l.ldw + 8)};
                    mma_bf16(acc[mt], av, b);
                }
            }
        }
        // Rows j = 16 mt + gid (+ 8), channels 2 tig, 2 tig + 1.
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = mt * 16 + gid + 8 * h;
                if (j < a.j) {
                    *reinterpret_cast<float2*>(t_s + q * l.pitch + j * kCg + 2 * tig) =
                        make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);
                }
            }
        }
    }
    __syncthreads();  // t is whole; Mw is no longer needed

    // 2. Mh into shared memory as fp32 (exact for bf16), zero-padded.
    {
        const int rows = MT * 16, cols = l.kt2 * 8;
        for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
            const int r = idx / cols, k = idx - r * cols;
            mh_s[r * l.ldh + k] = r < a.i && k < a.qh ? to_f32(mh[size_t(r) * a.qh + k]) : 0.f;
        }
    }
    __syncthreads();

    // 3. o = Mh . t: a warp per column j of t (its 8 channels are the N tile).
    const bool even_c = (a.c & 1) == 0;
    for (int j = warp; j < a.j; j += kWarps) {
        const float* tcol = t_s + j * kCg + gid;
        float acc[MT][4] = {};
        for (int ks = 0; ks < l.kt2; ++ks) {
            const int k = ks * 8 + tig;
            const float b0 = k < a.qh ? tcol[k * l.pitch] : 0.f;
            const float b1 = k + 4 < a.qh ? tcol[(k + 4) * l.pitch] : 0.f;
            tf32_step<kF32>(acc, mh_s + ks * 8, l.ldh, gid, tig, b0, b1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = mt * 16 + gid + 8 * h, ch = c0 + 2 * tig;
                if (i >= a.i || ch >= a.c) continue;
                float* dst = out + (size_t(i) * a.j + j) * a.c + ch;
                if (even_c) {  // ch + 1 < c, and dst is 8-byte aligned
                    *reinterpret_cast<float2*>(dst) =
                        make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);
                } else {
                    dst[0] = acc[mt][2 * h];
                    if (ch + 1 < a.c) dst[1] = acc[mt][2 * h + 1];
                }
            }
        }
    }
}

template <typename T, int MT>
int launch(const void* p, const void* mw, const void* mh, void* out, const Args& a,
           cudaStream_t stream) {
    auto kernel = fir_banded_kernel<T, MT>;
    const size_t smem = a.l.t_bytes + a.l.m_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3(unsigned((a.c + kCg - 1) / kCg)), kThreads, smem, stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(mw), static_cast<const T*>(mh),
        static_cast<float*>(out), a);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* p, const void* mw, const void* mh, void* out, const Args& a,
             cudaStream_t s) {
    switch (a.l.mt) {
        case 1: return launch<T, 1>(p, mw, mh, out, a, s);
        case 2: return launch<T, 2>(p, mw, mh, out, a, s);
        case 3: return launch<T, 3>(p, mw, mh, out, a, s);
        case 4: return launch<T, 4>(p, mw, mh, out, a, s);
        case 5: return launch<T, 5>(p, mw, mh, out, a, s);
        case 6: return launch<T, 6>(p, mw, mh, out, a, s);
        case 7: return launch<T, 7>(p, mw, mh, out, a, s);
        default: return launch<T, 8>(p, mw, mh, out, a, s);
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, dtype 0 = float32, 1 = bfloat16.
size_t sg3_fir_banded_smem_bytes(int qh, int qw, int j, int i, int dtype) {
    const Layout l = dtype == 0 ? layout<float>(qh, qw, j, i) : layout<__nv_bfloat16>(qh, qw, j, i);
    return l.t_bytes + l.m_bytes;
}

// p [qh, qw, c], mw [j, qw], mh [i, qh]: contiguous device tensors of one
// dtype, 0 = float32, 1 = bfloat16, with qw, j, i <= 128. out: float32
// [i, j, c] on the device. Returns the cudaError_t of the launch (0 on
// success).
int sg3_fir_banded(const void* p, const void* mw, const void* mh, void* out, int dtype,
                   int qh, int qw, int c, int j, int i, void* stream) {
    if (qh < 1 || qw < 1 || qw > kMaxQw || c < 1 || j < 1 || i < 1 || j > 16 * kMaxMt ||
        i > 16 * kMaxMt ||
        (dtype != 0 && dtype != 1)) {
        return int(cudaErrorInvalidValue);
    }
    Args a{qh, qw, c, j, i, dtype == 0 ? layout<float>(qh, qw, j, i)
                                       : layout<__nv_bfloat16>(qh, qw, j, i)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? dispatch<float>(p, mw, mh, out, a, s)
                      : dispatch<__nv_bfloat16>(p, mw, mh, out, a, s);
}

}  // extern "C"
