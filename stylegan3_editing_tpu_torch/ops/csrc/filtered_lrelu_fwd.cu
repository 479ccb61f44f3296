// Fused filtered leaky ReLU, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flrelu_kernel` of `fused_filtered_lrelu`
// (stylegan3_editing_tpu/ops/pallas_flrelu.py). For an NHWC input it computes
//   bias (on real pixels) -> zero-stuff x`up` -> pad/crop -> up-FIR (1-D fu,
//   both axes) -> lrelu * gain, clamp -> stride-2 down-FIR (1-D fd on both
//   axes, or a 2-D fd)
// in one pass: each block holds one 16x16 output tile of one image for 8
// channels, and the x`up` intermediate grid lives only in shared memory.
//
// Bound on the card: the composition moves the up-sampled grid (u^2 times the
// input) through device memory several times; this kernel reads the input and
// writes the output once, so its byte floor is bytes(in + out) / 3.35 TB/s.
// Its operations are ~6 FMA per up-grid point per axis plus 144 (radial fd)
// or 24 (separable fd) FMA per output, in fp32; on SG3-R they are the larger
// term. What the design does about it:
// - the geometry (taps, tile, channel group) is compile-time, so every tap
//   loop unrolls and the index arithmetic folds;
// - the taps ride in the kernel's parameter space (__grid_constant__), so a
//   down-pass FMA reads its tap as a constant operand, not from shared memory;
// - the up passes touch only the non-zero (every u-th) taps, and are
//   register-blocked: a thread loads a run of 8/u + tu/u inputs once and
//   computes 8 up-grid samples from it;
// - the down pass is register-blocked the same way: a thread keeps a run of
//   2*8+td-2 up-grid values in registers and feeds 8 outputs from it;
// - the row pitches are padded so a warp's 32 lanes hit 32 banks;
// - on bf16 inputs with a radial fd (SG3-R's L5-L11) the down pass, 144 of
//   the ~200 FMA per output, runs on the tensor cores (`mma_down`): per 4x4
//   M-tile of outputs, D[16 outputs][8 channels] = W[16][336] . B[336][8],
//   with B the 18x18 window of the up grid under the M-tile and W the fd
//   taps placed at each output's offset in it (the same for every M-tile,
//   built on the host: flrelu_cuda.mma_down_operand). W and the up grid are
//   each split into bf16 hi + lo, and hi.hi + hi.lo + lo.hi (m16n8k16
//   mma.sync, fp32 sums) keep ~2^-16 of the fp32 result. The up passes stay
//   on the CUDA cores;
// - on those layers a thread loads a pixel's 8 input channels with one or
//   two aligned 16-byte loads (`load_tile_bf16`) instead of 8 lanes with a
//   2-byte load each: the input tile's element loads took most of a block's
//   time at u = 2.
// TMA and pipelining are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libflrelu.so filtered_lrelu_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"  // mma_bf16, split_bf16, ldmatrix_x4(_trans), cp_async_16

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // output tile side
constexpr int kCg = 8;     // channels per block, the fastest index in shared memory
constexpr int kR = 8;      // outputs per thread along the blocked axis of the down pass
constexpr int kUpOut = 8;  // up-grid outputs per thread in each up pass
constexpr int kMaxTu = 24, kMaxTd = 12;
// The tensor-core down pass: M-tiles of kMmaTile^2 = 16 outputs (the MMA's
// M) over the block's 8 channels (its N); 8 warps take two M-tiles each of
// the 16 in a tile. K runs over the M-tile's kMmaWin^2 window of the up grid
// in kKSteps steps of 16: steps 0-17 are window row s, columns 0-15; steps
// 18-20 columns 16-17 of rows 8t .. 8t + 7 as (row, column) pairs, rows
// past 17 padding (W is zero there; the kernel reads row 17 for them).
// flrelu_cuda.mma_down_window_offsets holds the same order.
constexpr int kMmaTile = 4;
constexpr int kMmaWin = 2 * (kMmaTile - 1) + kMaxTd;  // 18
constexpr int kKSteps = 21;
constexpr int kWCols = 16 * kKSteps;  // W's columns in device memory (336)
// W's row pitch in shared memory (bf16): rows 688 B apart put an ldmatrix
// tile's 8 rows on 8 distinct 16-byte groups of banks.
constexpr int kWPitch = kWCols + 8;
static_assert(kMmaWin == 18 && kMmaWin * kMmaWin <= kWCols &&
              16 * (kKSteps - kMmaWin) >= 2 * kMmaWin, "K steps cover the window");
static_assert(kTile == 4 * kMmaTile && kThreads / 32 * 2 == kMmaTile * kMmaTile,
              "8 warps take two M-tiles each");

struct Geometry {
    int n, h, w, c;     // input (NHWC)
    int out_h, out_w;   // output spatial size
    int py0, px0;       // low padding on the up grid (negative = crop)
    float gain, slope, clamp;
    int tiles_w;
};

// Correlation-order taps: fu with the up gain folded in; fd 1-D or row-major 2-D.
struct Taps {
    float fu[kMaxTu];
    float fd[kMaxTd * kMaxTd];
};

// Smallest v' >= v with v' % m == r.
constexpr int pad_to(int v, int m, int r) { return v + ((r - v % m) % m + m) % m; }

template <int U, int TU, int TD>
struct Shape {
    static constexpr int kLog2U = U == 2 ? 1 : 2;
    static constexpr int kSpan = 2 * (kTile - 1) + TD;  // up-grid side of a tile
    // An up pass covers the up grid in groups of kUpOut samples that start on
    // a stuffed input pixel; a group reads kRun consecutive inputs.
    static constexpr int kSteps = kUpOut / U;            // input pixels per group
    static constexpr int kGroups = (kSpan + U - 1 + kUpOut - 1) / kUpOut;
    static constexpr int kRun = kSteps + TU / U;
    static constexpr int kIn = kSteps * kGroups + TU / U;  // input side of a tile
    // Pitches ≡ kCg (mod 32) let the 32 / kCg row groups of a warp cover 32
    // banks; the up-grid pitch is half that, as the down pass steps 2 rows.
    static constexpr int kXPitch = pad_to(kIn * kCg, 32, kCg);    // input tile row
    static constexpr int kT1Pitch = pad_to(kSpan * kCg, 32, kCg);  // W-upsampled row
    static constexpr int kAPitch = pad_to(kSpan * kCg, 16, kCg / 2);  // up-grid row
    static constexpr int kDPitch = pad_to(kTile * kCg, 32, kCg);  // W-downsampled row
    static constexpr int kBuf0 = kIn * kXPitch > kSpan * kAPitch ? kIn * kXPitch
                                                                  : kSpan * kAPitch;
    static constexpr int kBuf1 = kIn * kT1Pitch > kSpan * kDPitch ? kIn * kT1Pitch
                                                                   : kSpan * kDPitch;
    static constexpr size_t kSmemBytes = sizeof(float) * size_t(kBuf0 + kBuf1);
    // The tensor-core down pass keeps the up grid in buf0 as two bf16 planes
    // (hi, lo) of [kSpan][kSpan][kCg]: a pixel's 8 channels are one 16-byte
    // row of an ldmatrix tile, and a row of 42 pixels (672 B = 32 mod 128)
    // puts 4 consecutive rows on distinct banks. W (hi, lo) goes to buf1.
    static constexpr int kPlane = kSpan * kSpan * kCg;  // bf16 elements
    static_assert(2 * kPlane * 2 <= 4 * kBuf0 && 2 * 16 * kWPitch * 2 <= 4 * kBuf1,
                  "the tensor-core down pass fits the buffers");
    static_assert(U == 2 || U == 4, "up factor 2 or 4");
    static_assert(TU % U == 0 && TU <= kMaxTu && TD <= kMaxTd, "tap counts");
    static_assert(kTile % kR == 0 && kUpOut % U == 0, "register blocking");
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// One group of an up pass: kUpOut up-grid samples from kRun inputs
// src[q * stride], the first on a stuffed pixel. Sample m takes phase
// p = -m mod U, i.e. taps fu[p + U*q] on inputs ceil(m / U) + q.
template <int U, int TU, int RUN>
__device__ __forceinline__ void up_run(const Taps& t, const float* src, int stride,
                                       float (&acc)[kUpOut]) {
    float v[RUN];
#pragma unroll
    for (int q = 0; q < RUN; ++q) v[q] = src[q * stride];
#pragma unroll
    for (int m = 0; m < kUpOut; ++m) {
        const int p = (U - m % U) % U, off = (m + p) / U;
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < TU / U; ++q) a = fmaf(t.fu[p + U * q], v[off + q], a);
        acc[m] = a;
    }
}

// Step 1 on bf16 tensor-core layers: the input tile [KIN][KIN][kCg] by
// pixels, bias on real pixels, zeros elsewhere. A pixel's channels c0 ..
// c0 + 7 are 16 bytes that lie in one or two aligned 16-byte chunks of x
// (ragged channel counts misalign them), so a thread loads the chunks and
// shifts the slice out in registers: a word shift by 2 and by 1 (selects),
// then a funnel shift by 0 or 16 bits. Channels past g.c are zero; a pixel
// whose chunks would reach past either end of x loads element by element.
template <int KIN, int XPITCH>
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ x,
                                               const float* __restrict__ bias, float* buf0,
                                               const Geometry& g, int n, int c0, int i0_y,
                                               int i0_x) {
    const int nc = min(kCg, g.c - c0);  // real channels of the group
    float b[kCg];
#pragma unroll
    for (int k = 0; k < kCg; ++k) b[k] = k < nc ? bias[c0 + k] : 0.f;
    const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
    const uintptr_t x_hi = reinterpret_cast<uintptr_t>(x + size_t(g.n) * g.h * g.w * g.c);
    for (int p = threadIdx.x; p < KIN * KIN; p += kThreads) {
        const int col = p % KIN, row = p / KIN;
        const int iy = i0_y + row, ix = i0_x + col;
        float f[kCg] = {};
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
            const __nv_bfloat16* px = x + ((size_t(n) * g.h + iy) * g.w + ix) * g.c + c0;
            const uintptr_t a = reinterpret_cast<uintptr_t>(px), base = a & ~uintptr_t(15);
            const int sh = int(a - base) >> 1;  // the slice's first element in the chunk
            if (base >= x_lo && base + 32 <= x_hi) {
                const uint4* src = reinterpret_cast<const uint4*>(base);
                const uint4 q0 = __ldg(src);
                const uint4 q1 = sh + nc > kCg ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
                uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
                if (sh & 4) {
#pragma unroll
                    for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
                }
                if (sh & 2) {
#pragma unroll
                    for (int j = 0; j < 5; ++j) w[j] = w[j + 1];
                }
#pragma unroll
                for (int k = 0; k < kCg / 2; ++k) {  // bf16 -> fp32 is a 16-bit shift
                    const uint32_t pair = __funnelshift_r(w[k], w[k + 1], 16 * (sh & 1));
                    f[2 * k] = __uint_as_float(pair << 16);
                    f[2 * k + 1] = __uint_as_float(pair & 0xffff0000u);
                }
            } else {
#pragma unroll
                for (int k = 0; k < kCg; ++k) f[k] = k < nc ? __bfloat162float(px[k]) : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kCg; ++k) f[k] = k < nc ? f[k] + b[k] : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(buf0 + row * XPITCH + col * kCg);
        dst[0] = make_float4(f[0], f[1], f[2], f[3]);
        dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
}

// acc[r] += sum_k f[k] * src[(2r + k) * stride], r < kR: R outputs of a
// stride-2 FIR from one register-resident run of 2R + TD - 2 samples.
template <int TD>
__device__ __forceinline__ void down_run(const float* f, const float* src, int stride,
                                         float (&acc)[kR]) {
    float v[2 * kR + TD - 2];
#pragma unroll
    for (int q = 0; q < 2 * kR + TD - 2; ++q) v[q] = src[q * stride];
#pragma unroll
    for (int k = 0; k < TD; ++k) {
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = fmaf(f[k], v[2 * r + k], acc[r]);
    }
}

// The down pass of a tile on the tensor cores: up = the hi and lo planes of
// the activated up grid, w_s = W's hi and lo ([2][16][kWPitch] bf16). Warp w
// takes M-tiles (w / 2, 2 (w % 2) + t), t = 0, 1; at each K step it loads
// W's fragments once for both, and per M-tile one ldmatrix.x4.trans brings
// the B fragments of hi and lo. The three products of a step accumulate in
// separate chains; store(oy, ox, c, v0, v1) writes channels c and c + 1.
template <int SPAN, typename Store>
__device__ __forceinline__ void mma_down(const __nv_bfloat16* up, const __nv_bfloat16* w_s,
                                         Store store) {
    constexpr int kPlane = SPAN * SPAN * kCg;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = lane >> 3, r = lane & 7;  // this lane's ldmatrix tile and row
    // A (W, row-major): tiles (m 0-7 | 8-15) x (k 0-7 | 8-15).
    const __nv_bfloat16* a_row = w_s + (r + 8 * (q & 1)) * kWPitch + 8 * (q >> 1);
    // B (the up grid, pixel-major, so .trans): tiles (k 0-7 | 8-15) of hi, then lo.
    const int kb = r + 8 * (q & 1);
    const __nv_bfloat16* b_plane = up + (q >> 1) * kPlane;
    const int my = kMmaTile * (warp >> 1);
    float acc[2][3][4] = {};
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, a_row + 16 * s);
        ldmatrix_x4(al, a_row + 16 * kWPitch + 16 * s);
        const int wi = s < kMmaWin ? s : min(8 * (s - kMmaWin) + (kb >> 1), kMmaWin - 1);
        const int wj = s < kMmaWin ? kb : 16 + (kb & 1);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int mx = kMmaTile * (2 * (warp & 1) + t);
            uint32_t b[4];
            ldmatrix_x4_trans(b, b_plane + ((2 * my + wi) * SPAN + 2 * mx + wj) * kCg);
            const uint32_t b_hi[2] = {b[0], b[1]}, b_lo[2] = {b[2], b[3]};
            mma_bf16(acc[t][0], ah, b_hi);
            mma_bf16(acc[t][1], ah, b_lo);
            mma_bf16(acc[t][2], al, b_hi);
        }
    }
    // D rows m = gid, gid + 8 are outputs (m / 4, m % 4) of the M-tile;
    // columns 2 tig, 2 tig + 1 its channels.
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        const int mx = kMmaTile * (2 * (warp & 1) + t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 2 * h + e;
                v[e] = (acc[t][1][i] + acc[t][2][i]) + acc[t][0][i];
            }
            const int m = gid + 8 * h;
            store(my + m / kMmaTile, mx + m % kMmaTile, 2 * tig, v[0], v[1]);
        }
    }
}

template <typename T, int U, int TU, int TD, bool RADIAL>
__global__ void __launch_bounds__(kThreads)
flrelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ wmma, T* __restrict__ out,
                  const __grid_constant__ Geometry g, const __grid_constant__ Taps taps) {
    using S = Shape<U, TU, TD>;
    // bf16 with a radial fd: the down pass runs on the tensor cores.
    constexpr bool kMma = RADIAL && std::is_same<T, __nv_bfloat16>::value;
    extern __shared__ __align__(16) float smem[];
    float* buf0 = smem;             // input tile, then the activated up grid
    float* buf1 = smem + S::kBuf0;  // W-upsampled rows, then W-downsampled rows (or W)
    __nv_bfloat16* up = reinterpret_cast<__nv_bfloat16*>(buf0);  // kMma: hi, lo planes

    const int tid = threadIdx.x;
    const int tile_y = blockIdx.x / g.tiles_w;
    const int tile_x = blockIdx.x - tile_y * g.tiles_w;
    const int c0 = blockIdx.y * kCg;
    const int n = blockIdx.z;
    const int oy0 = tile_y * kTile, ox0 = tile_x * kTile;
    // Up-grid sample 2*o0 + j sits at stuffed index base + j; input pixel i at
    // stuffed index i * U. The up passes start at j = -e, the last stuffed
    // pixel at or before j = 0, which is input pixel i0 = (base - e) / U, the
    // tile's first.
    const int base_y = 2 * oy0 - g.py0, base_x = 2 * ox0 - g.px0;
    const int e_y = base_y & (U - 1), e_x = base_x & (U - 1);
    const int i0_y = (base_y - e_y) >> S::kLog2U, i0_x = (base_x - e_x) >> S::kLog2U;

    // 1. Input tile [kIn][kIn][kCg]; the bias lands on real pixels only, so
    //    the padding stays zero.
    if constexpr (kMma) {
        load_tile_bf16<S::kIn, S::kXPitch>(x, bias, buf0, g, n, c0, i0_y, i0_x);
    } else {
        for (int idx = tid; idx < S::kIn * S::kIn * kCg; idx += kThreads) {
            const int c = idx % kCg, rest = idx / kCg;
            const int col = rest % S::kIn, row = rest / S::kIn;
            const int iy = i0_y + row, ix = i0_x + col, ch = c0 + c;
            float v = 0.f;
            if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w && ch < g.c) {
                v = load_f32(x + ((size_t(n) * g.h + iy) * g.w + ix) * g.c + ch) + bias[ch];
            }
            buf0[row * S::kXPitch + col * kCg + c] = v;
        }
    }
    __syncthreads();

    // 2. Up-FIR along W: buf1[row][j][c] for j in [0, span). Lanes run over
    //    (c, row); each thread computes one group of kUpOut samples.
    for (int idx = tid; idx < S::kIn * S::kGroups * kCg; idx += kThreads) {
        const int c = idx % kCg, row = (idx / kCg) % S::kIn, grp = idx / (kCg * S::kIn);
        float acc[kUpOut];
        up_run<U, TU, S::kRun>(
            taps, buf0 + row * S::kXPitch + S::kSteps * grp * kCg + c, kCg, acc);
#pragma unroll
        for (int m = 0; m < kUpOut; ++m) {
            const int j = -e_x + kUpOut * grp + m;
            if (j >= 0 && j < S::kSpan) buf1[row * S::kT1Pitch + j * kCg + c] = acc[m];
        }
    }
    __syncthreads();

    // 3. Up-FIR along H, then lrelu * gain and clamp: buf0[i][j][c] (kMma:
    //    bf16 hi and lo planes [i][j][c]). Lanes run over (c, j).
    for (int idx = tid; idx < S::kSpan * S::kGroups * kCg; idx += kThreads) {
        const int c = idx % kCg, j = (idx / kCg) % S::kSpan, grp = idx / (kCg * S::kSpan);
        float acc[kUpOut];
        up_run<U, TU, S::kRun>(
            taps, buf1 + S::kSteps * grp * S::kT1Pitch + j * kCg + c, S::kT1Pitch, acc);
#pragma unroll
        for (int m = 0; m < kUpOut; ++m) {
            const int i = -e_y + kUpOut * grp + m;
            float v = acc[m] >= 0.f ? acc[m] : acc[m] * g.slope;
            v *= g.gain;
            v = v < -g.clamp ? -g.clamp : (v > g.clamp ? g.clamp : v);
            if (i < 0 || i >= S::kSpan) continue;
            if constexpr (kMma) {
                split_bf16(v, up[(i * S::kSpan + j) * kCg + c],
                           up[S::kPlane + (i * S::kSpan + j) * kCg + c]);
            } else {
                buf0[i * S::kAPitch + j * kCg + c] = v;
            }
        }
    }
    __syncthreads();

    // 4-5. Stride-2 down-FIR, kR outputs per thread, and store.
    auto store = [&](int oy, int ox, int c, float v) {
        const int gy = oy0 + oy, gx = ox0 + ox, ch = c0 + c;
        if (gy < g.out_h && gx < g.out_w && ch < g.c)
            store_f32(out + ((size_t(n) * g.out_h + gy) * g.out_w + gx) * g.c + ch, v);
    };
    if constexpr (kMma) {
        // W's hi and lo into buf1 (rows of kWCols to rows of kWPitch); the
        // 21.5 KB stay in L2 between blocks.
        __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(buf1);
        constexpr int kChunks = kWCols / 8;  // 16-byte chunks of a row
        for (int idx = tid; idx < 2 * 16 * kChunks; idx += kThreads) {
            const int row = idx / kChunks, chunk = idx - row * kChunks;
            cp_async_16(w_s + row * kWPitch + 8 * chunk, wmma + row * kWCols + 8 * chunk);
        }
        cp_async_wait_all();
        __syncthreads();
        const bool even_c = (g.c & 1) == 0;
        mma_down<S::kSpan>(up, w_s, [&](int oy, int ox, int c, float v0, float v1) {
            const int gy = oy0 + oy, gx = ox0 + ox, ch = c0 + c;
            if (gy >= g.out_h || gx >= g.out_w || ch >= g.c) return;
            T* p = out + ((size_t(n) * g.out_h + gy) * g.out_w + gx) * g.c + ch;
            if (even_c) {  // ch + 1 < c, and p is 4-byte aligned
                *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
            } else {
                p[0] = __float2bfloat16_rn(v0);
                if (ch + 1 < g.c) p[1] = __float2bfloat16_rn(v1);
            }
        });
    } else if constexpr (RADIAL) {
        // Lanes run over (c, oy); each thread computes ox .. ox + kR - 1.
        for (int idx = tid; idx < kTile * (kTile / kR) * kCg; idx += kThreads) {
            const int c = idx % kCg, oy = (idx / kCg) % kTile, ox = idx / (kCg * kTile) * kR;
            float acc[kR] = {};
#pragma unroll
            for (int ky = 0; ky < TD; ++ky) {
                down_run<TD>(taps.fd + ky * TD,
                             buf0 + (2 * oy + ky) * S::kAPitch + 2 * ox * kCg + c, kCg, acc);
            }
#pragma unroll
            for (int r = 0; r < kR; ++r) store(oy, ox + r, c, acc[r]);
        }
    } else {
        // Along W into buf1[i][ox][c]; lanes over (c, i).
        for (int idx = tid; idx < S::kSpan * (kTile / kR) * kCg; idx += kThreads) {
            const int c = idx % kCg, i = (idx / kCg) % S::kSpan;
            const int ox = idx / (kCg * S::kSpan) * kR;
            float acc[kR] = {};
            down_run<TD>(taps.fd, buf0 + i * S::kAPitch + 2 * ox * kCg + c, kCg, acc);
#pragma unroll
            for (int r = 0; r < kR; ++r) buf1[i * S::kDPitch + (ox + r) * kCg + c] = acc[r];
        }
        __syncthreads();
        // Along H; lanes over (c, ox), each thread computes oy .. oy + kR - 1.
        for (int idx = tid; idx < kTile * (kTile / kR) * kCg; idx += kThreads) {
            const int c = idx % kCg, ox = (idx / kCg) % kTile, oy = idx / (kCg * kTile) * kR;
            float acc[kR] = {};
            down_run<TD>(taps.fd, buf1 + 2 * oy * S::kDPitch + ox * kCg + c, S::kDPitch, acc);
#pragma unroll
            for (int r = 0; r < kR; ++r) store(oy + r, ox, c, acc[r]);
        }
    }
}

template <typename T, int U, int TU, int TD, bool RADIAL>
int launch(const void* x, const void* bias, const void* wmma, void* out, const Geometry& g,
           const Taps& taps, cudaStream_t stream) {
    using S = Shape<U, TU, TD>;
    auto kernel = flrelu_fwd_kernel<T, U, TU, TD, RADIAL>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmemBytes));
    if (err != cudaSuccess) return int(err);
    const int tiles_h = (g.out_h + kTile - 1) / kTile;
    dim3 grid(unsigned(tiles_h * g.tiles_w), unsigned((g.c + kCg - 1) / kCg), unsigned(g.n));
    kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(bias),
        static_cast<const __nv_bfloat16*>(wmma), static_cast<T*>(out), g, taps);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* bias, const void* w, void* out, const Geometry& g,
             const Taps& taps, int up, int radial, cudaStream_t s) {
    if (up == 2) {
        return radial ? launch<T, 2, 12, 12, true>(x, bias, w, out, g, taps, s)
                      : launch<T, 2, 12, 12, false>(x, bias, w, out, g, taps, s);
    }
    return radial ? launch<T, 4, 24, 12, true>(x, bias, w, out, g, taps, s)
                  : launch<T, 4, 24, 12, false>(x, bias, w, out, g, taps, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at up factor 2 or 4 (ptxas does not
// report it).
size_t sg3_flrelu_fwd_smem_bytes(int up) {
    return up == 2 ? Shape<2, 12, 12>::kSmemBytes : Shape<4, 24, 12>::kSmemBytes;
}

// x, out: NHWC device tensors, dtype 0 = float32, 1 = bfloat16. bias: float32
// [c] on the device. fu, fd: host float32 correlation-order taps (fu with the
// up gain folded in; fd 1-D, or 2-D row-major when radial). wmma: for bf16
// with a radial fd, the tensor-core down pass's operand W as bf16 [2 (hi,
// lo)][16][336] on the device, 16-byte aligned (flrelu_cuda.mma_down_operand);
// otherwise unused. Supported: up 2 with 12 fu taps or up 4 with 24, and 12
// fd taps per axis. Returns the cudaError_t of the launch (0 on success).
int sg3_flrelu_fwd(const void* x, const void* bias, const float* fu, const float* fd,
                   const void* wmma, void* out, int dtype, int n, int h, int w, int c,
                   int out_h, int out_w, int up, int tu, int td, int radial, int py0,
                   int px0, float gain, float slope, float clamp, void* stream) {
    if (!((up == 2 && tu == 12) || (up == 4 && tu == 24)) || td != 12 ||
        (dtype != 0 && dtype != 1) ||
        (dtype == 1 && radial && (wmma == nullptr || uintptr_t(wmma) % 16 != 0))) {
        return int(cudaErrorInvalidValue);
    }
    Geometry g{n, h, w, c, out_h, out_w, py0, px0, gain, slope, clamp,
               (out_w + kTile - 1) / kTile};
    Taps taps{};
    for (int i = 0; i < tu; ++i) taps.fu[i] = fu[i];
    for (int i = 0; i < (radial ? td * td : td); ++i) taps.fd[i] = fd[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? dispatch<float>(x, bias, wmma, out, g, taps, up, radial, s)
                      : dispatch<__nv_bfloat16>(x, bias, wmma, out, g, taps, up, radial, s);
}

}  // extern "C"
