// Fused filtered leaky ReLU, backward (dx), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flrelu_bwd_kernel` / `_flrelu_bwd_kernel_mxu` of
// `fused_filtered_lrelu_bwd` (stylegan3_editing_tpu/ops/pallas_flrelu.py). For
// the forward  y = down2(fd, clamp(lrelu(up_u(fu, x + b)) * gain))  it computes
//   dx = down_u(fu, up2(fd, dy) * act'(A) * gain * u^2),  A = up_u(fu, x + b),
// on the backward frame of the up grid (the forward's, shifted by tu-1-p0):
//   1. x tile (+ bias on real pixels only) and dy tile, both loaded at block
//      start with wide loads of a pixel's 4-channel slice;
//   2-3. A by the forward's up-FIR, and from A the mask act'(A) * gain * u^2,
//      zero where |lrelu(A) * gain| > clamp: the forward's own mask,
//      recomputed, so no sign tensor is stored;
//   4. x2 up-FIR of dy by correlation with fd (the 36 real taps of the 12x12
//      radial fd per up-grid point, or two 1-D passes), times the mask;
//   5-6. stride-u down-FIR by correlation with fu along W, then H -> dx.
// Each block holds one 16 x 16 dx tile of one image for 4 channels; the up
// grid of the tile, u*15 + tu on a side (42 at u = 2, 84 at u = 4), lives
// only in shared memory. At the forward's 8 channels the u = 4 up grid alone
// would take 84^2 * 8 * 4 B = 226 KB of the 227 KB a block may have. Halving
// the tile to 8 instead would keep 8 channels but recompute a 52^2 up grid
// for 32^2 of output, 2.6x the work (the first version did; PERF.md has both
// versions' times). On the CUDA-core route blocks take 72 KB (u = 2, three
// per SM, 512 threads each) or 205 KB (u = 4 radial, one per SM, 1024
// threads), so an SM keeps 32-48 warps in flight; a separable fd at u = 4
// needs one more 84-wide buffer, so there the tile is 8 wide.
//
// Bound on the card: bytes(dy + x + dx) / 3.35 TB/s against its fp32
// operations on the CUDA cores (the dy up pass, the A recompute, the mask and
// the down pass); on SG3-R the operations are the larger term. As in the
// forward kernel, the geometry is compile-time, the taps ride in the kernel's
// parameter space, and every pass is register-blocked (8 up-grid samples, or
// kT/2 outputs, per thread from one register-resident run of inputs).
// Device memory is touched as whole slices: a thread loads a pixel's 4
// channels of x and of dy from the one or two aligned 16-byte chunks that
// hold them (`load_slice_words`; element loads only at the ends of a tensor)
// and stores a pixel's 4 channels of dx with one 8-byte (bf16) or 16-byte
// (fp32) store where the slice is aligned. The grid's fastest index is the
// channel group, so the blocks that share a 32-byte sector of x, dy or dx
// run together and the sector is fetched once.
//
// On bf16 inputs with a radial fd (SG3-R's L5-L11) the dy up pass, 70-73 %
// of the FMA, runs on the tensor cores (`mma_up`). Mapping: M = the 16
// points of a 4x4 M-tile of the up grid, N = 8 = the block's 4 channels in
// each of two M-tiles kHalf apart in the list of a tile's M-tiles (lanes
// with gid / 4 = 0 or 1 take the first or the second), K = the 64 pixels of
// the 8x8 dy window under an M-tile, 4 k16 steps of two window rows each.
// Every M-tile of a launch starts on the same stuffing parity (its origin is
// U*16*tile + 4*i - pp0), so W [16][64] (fd placed at each point's offset,
// 36 taps per row) is one matrix per launch, built on the host
// (flrelu_cuda.mma_up_operand) and passed as A fragments, lane by lane. dy
// is bf16, so it is exact as an operand: only W is split, and hi.dy + lo.dy
// (m16n8k16 mma.sync, fp32 sums) keep ~2^-17 of the fp32 result. dy stays
// bf16 in shared memory, in planes [c][row][col], so a B register (two
// neighbouring window pixels of one channel) is one aligned 32-bit load; the
// plane stride (≡ 8 words mod 32) keeps a warp's loads on distinct banks.
// Useful MACs per mma.sync: 16 points x 8 columns x 36 taps over 4 steps x
// 2 products = 576 (of 2,048). At u = 4 a lane keeps W's 8 fragments (32
// registers) for the whole pass; at u = 2 the pass reads them per step
// through L1. Shared memory per block on these layers: 63,744 B at u = 2,
// 179,584 B at u = 4 (one block per SM, 1,024 threads). At u = 2 the launch
// bounds allow two blocks per SM, not the three that shared memory would:
// ptxas (CUDA 12.8) then gives 61 registers and no spill, where the 40 of
// three blocks spilled 76 bytes and ran 14-17 % slower (PERF.md). At u = 4
// it gives 56.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libflrelu_bwd.so filtered_lrelu_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"  // mma_bf16

namespace {

constexpr int kCg = 4;     // channels per block, the fastest index in shared memory
constexpr int kUpOut = 8;  // up-grid outputs per thread in each up pass
constexpr int kMaxTu = 24, kMaxTd = 12;

struct Geometry {
    int n, h, w, c;      // x and dx (NHWC)
    int yh, yw;          // dy
    int ppy0, ppx0;      // low padding of dy's x2 up pass (backward frame)
    float gain, slope, clamp, point_gain;  // point_gain = gain * up^2
    int tiles_w;
};

// Correlation-order taps: fu_a = fu[::-1] * up (the forward's up pass, for A);
// fu_d = fu (the stride-u down pass); fd as given, 1-D or row-major 2-D.
struct Taps {
    float fu_a[kMaxTu];
    float fu_d[kMaxTu];
    float fd[kMaxTd * kMaxTd];
};

// Smallest v' >= v with v' % m == r.
constexpr int pad_to(int v, int m, int r) { return v + ((r - v % m) % m + m) % m; }
constexpr int max2(int a, int b) { return a > b ? a : b; }

template <int U, int TU, int TD, bool RADIAL, bool MMA>
struct Shape {
    static constexpr int kThreads = U == 2 ? 512 : 1024;
    static constexpr int kWarps = kThreads / 32;
    static constexpr bool kMma = MMA;  // the dy up pass on the tensor cores
    // Blocks per SM the registers must allow: at u = 2 the tensor-core pass
    // needs more than the 40 of three blocks, which spilled and ran slower.
    static constexpr int kMinBlocks = U == 2 ? (MMA ? 2 : 3) : 1;
    static constexpr int kLog2U = U == 2 ? 1 : 2;
    static constexpr int kT = U == 4 && !RADIAL ? 8 : 16;  // dx tile side
    static constexpr int kR = kT / 2;                   // dx outputs per thread in a down pass
    static constexpr int kSpan = U * (kT - 1) + TU;     // up-grid side of a tile
    // An up pass covers the up grid in groups of kUpOut samples that start on
    // a stuffed input pixel; a group reads kRun consecutive inputs. A: x
    // stuffed by U; G: dy stuffed by 2.
    static constexpr int kStepsA = kUpOut / U;
    static constexpr int kGroupsA = (kSpan + U - 1 + kUpOut - 1) / kUpOut;
    static constexpr int kRunA = kStepsA + TU / U;
    static constexpr int kInA = kStepsA * kGroupsA + TU / U;  // x tile side
    static constexpr int kStepsG = kUpOut / 2;
    static constexpr int kGroupsG = (kSpan + 1 + kUpOut - 1) / kUpOut;
    static constexpr int kRunG = kStepsG + TD / 2;
    static constexpr int kInG = kStepsG * kGroupsG + TD / 2;  // dy tile side
    // Pitches ≡ kCg (mod 32) let the 32 / kCg row groups of a warp cover 32 banks.
    static constexpr int kXPitch = pad_to(kInA * kCg, 32, kCg);   // x tile row
    static constexpr int kYPitch = pad_to(kInG * kCg, 32, kCg);   // dy tile row
    static constexpr int kT1Pitch = pad_to(kSpan * kCg, 32, kCg); // W-upsampled row
    static constexpr int kMPitch = pad_to(kSpan * kCg, 32, kCg);  // up-grid row
    static constexpr int kDPitch = pad_to(kT * kCg, 32, kCg);     // W-downsampled row
    // The tensor-core pass: bf16 dy planes [kCg][kInG][kInG], the plane
    // stride ≡ 16 elements (8 words) mod 64; M-tiles per side of the up
    // grid, and the distance between the two M-tiles of a task.
    static constexpr int kPlane = pad_to(kInG * kInG, 64, 16);
    static constexpr int kMTiles = (kSpan + 3) / 4;
    static constexpr int kHalf = (kMTiles * kMTiles + 1) / 2;
    // Regions, in floats. buf0: the x tile (phases 1-2), then the mask and
    // dA (3-5), then the dx tile (6). buf1: the dy tile (1-4), fp32
    // [kInG][kYPitch], or the bf16 planes. buf2: the W-upsampled rows (2-3,
    // and 4 if separable), then the W-downsampled rows (5-6).
    static constexpr int kBuf0 = max2(max2(kSpan * kMPitch, kInA * kXPitch), kT * kT * kCg);
    static constexpr int kBuf1 = MMA ? kCg * kPlane / 2 : kInG * kYPitch;
    static constexpr int kBuf2 = max2((RADIAL ? kInA : max2(kInA, kInG)) * kT1Pitch,
                                      kSpan * kDPitch);
    static constexpr size_t kSmemBytes = sizeof(float) * size_t(kBuf0 + kBuf1 + kBuf2);
    static_assert(U == 2 || U == 4, "up factor 2 or 4");
    static_assert(TU % U == 0 && TU <= kMaxTu && TD % 2 == 0 && TD <= kMaxTd, "tap counts");
    static_assert(kSpan % 2 == 0, "the radial G pass walks row pairs");
    static_assert(kT * kT <= kThreads, "one thread per dx pixel in the store");
    static_assert(!MMA || (RADIAL && TD == 12 && kInG % 2 == 0 &&
                           2 * (kMTiles - 1) + 8 <= kInG),
                  "the tensor-core pass: 12x12 fd, pixel pairs, windows inside the dy tile");
    static_assert(kSmemBytes <= 232448, "a block may hold 227 KB of shared memory");
};

// A pixel's channel slice p[0 .. nc), nc <= 4, as 32-bit words: two bf16
// channel pairs (low half first) or four fp32 values, zero past nc. The
// slice lies in one or two aligned 16-byte chunks of [lo, hi) (ragged channel
// counts misalign it): the thread loads them and shifts the slice out in
// registers, a word shift by 2 and by 1 (selects), then for bf16 a funnel
// shift by 0 or 16 bits. A slice whose chunks would reach past either end of
// the tensor loads element by element.
template <typename T>
__device__ __forceinline__ void load_slice_words(const T* p, int nc, const T* lo, const T* hi,
                                                 uint32_t (&out)[kCg * sizeof(T) / 4]) {
    constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
    constexpr int kWords = kCg * sizeof(T) / 4;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p), base = a & ~uintptr_t(15);
    const int sh = int(a - base);  // bytes of the first chunk before the slice
    const bool two = sh + nc * int(sizeof(T)) > 16;
    if (base >= reinterpret_cast<uintptr_t>(lo) &&
        base + (two ? 32 : 16) <= reinterpret_cast<uintptr_t>(hi)) {
        const uint4* src = reinterpret_cast<const uint4*>(base);
        const uint4 q0 = __ldg(src);
        const uint4 q1 = two ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
        uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        if (sh & 8) {
#pragma unroll
            for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
        }
        if (sh & 4) {
#pragma unroll
            for (int j = 0; j < 5; ++j) w[j] = w[j + 1];
        }
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
            out[k] = kBf16 ? __funnelshift_r(w[k], w[k + 1], 8 * (sh & 2)) : w[k];
        }
    } else {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
            if constexpr (kBf16) {
                out[k] = (2 * k < nc ? uint32_t(__bfloat16_as_ushort(p[2 * k])) : 0u) |
                         (2 * k + 1 < nc ? uint32_t(__bfloat16_as_ushort(p[2 * k + 1])) << 16
                                         : 0u);
            } else {
                out[k] = k < nc ? __float_as_uint(p[k]) : 0u;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {  // zero the channels past nc
        const int first = kBf16 ? 2 * k : k;
        out[k] &= first >= nc ? 0u : (kBf16 && first + 1 >= nc ? 0xffffu : 0xffffffffu);
    }
}

// The same slice as floats (bf16 -> fp32 is a 16-bit shift).
template <typename T>
__device__ __forceinline__ void load_slice(const T* p, int nc, const T* lo, const T* hi,
                                           float (&f)[kCg]) {
    uint32_t w[kCg * sizeof(T) / 4];
    load_slice_words(p, nc, lo, hi, w);
#pragma unroll
    for (int k = 0; k < kCg; ++k) {
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            f[k] = __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
        } else {
            f[k] = __uint_as_float(w[k]);
        }
    }
}

// A tile [KIN][KIN] of pixels' 4-channel slices (+ bias on real pixels)
// into dst[row * PITCH + col * kCg + c], zeros past the tensor's edges.
template <int THREADS, int KIN, int PITCH, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, const float* bias,
                                          float* dst, int n, int h, int w, int c, int c0,
                                          int i0_y, int i0_x, int n_img) {
    const int nc = min(kCg, c - c0);
    const T* lo = src;
    const T* hi = src + size_t(n_img) * h * w * c;
    for (int p = threadIdx.x; p < KIN * KIN; p += THREADS) {
        const int col = p % KIN, row = p / KIN;
        const int iy = i0_y + row, ix = i0_x + col;
        float f[kCg] = {};
        if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
            load_slice(src + ((size_t(n) * h + iy) * w + ix) * c + c0, nc, lo, hi, f);
            if (bias != nullptr) {
#pragma unroll
                for (int k = 0; k < kCg; ++k) f[k] += k < nc ? bias[c0 + k] : 0.f;
            }
        }
        *reinterpret_cast<float4*>(dst + row * PITCH + col * kCg) =
            make_float4(f[0], f[1], f[2], f[3]);
    }
}

// The bf16 dy tile of the tensor-core pass into planes dst[c][row][col]
// (KIN x KIN, plane stride PLANE elements), zeros past the tensor's edges:
// one thread per pixel pair (col, col + 1), so each plane takes one 32-bit
// store of the pair's two values.
template <int THREADS, int KIN, int PLANE>
__device__ __forceinline__ void load_tile_planes(const __nv_bfloat16* __restrict__ src,
                                                 __nv_bfloat16* dst, int n, int h, int w, int c,
                                                 int c0, int i0_y, int i0_x, int n_img) {
    const int nc = min(kCg, c - c0);
    const __nv_bfloat16* lo = src;
    const __nv_bfloat16* hi = src + size_t(n_img) * h * w * c;
    for (int p = threadIdx.x; p < KIN * KIN / 2; p += THREADS) {
        const int col = 2 * (p % (KIN / 2)), row = p / (KIN / 2);
        const int iy = i0_y + row;
        uint32_t v[2][2] = {};  // [pixel][channel pair]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int ix = i0_x + col + e;
            if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
                load_slice_words(src + ((size_t(n) * h + iy) * w + ix) * c + c0, nc, lo, hi,
                                 v[e]);
            }
        }
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + row * KIN + col);
#pragma unroll
        for (int k = 0; k < kCg / 2; ++k) {  // channels 2k (low halves) and 2k + 1
            d[(2 * k) * (PLANE / 2)] = __byte_perm(v[0][k], v[1][k], 0x5410);
            d[(2 * k + 1) * (PLANE / 2)] = __byte_perm(v[0][k], v[1][k], 0x7632);
        }
    }
}

// 4 on the tensor cores: buf0[i][j][c] *= G, G = W . dy per M-tile (see the
// note at the top). ys: the dy planes; wfrag: W's hi and lo as A fragments,
// [2][4 steps][32 lanes] x 4 words. Task t of a warp takes M-tiles t and
// t + kHalf of the tile's kMTiles^2; a lane loads B for the M-tile of its
// column (gid / 4) and updates the points of its D columns (tig / 2).
template <typename S>
__device__ __forceinline__ void mma_up(const __nv_bfloat16* ys, const uint4* __restrict__ wfrag,
                                       float* buf0) {
    constexpr int kTiles = S::kMTiles * S::kMTiles;
    constexpr bool kWRegs = S::kThreads == 1024;  // u = 4: one block per SM, 64 registers
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    uint4 wr[kWRegs ? 8 : 1];
    if constexpr (kWRegs) {
#pragma unroll
        for (int i = 0; i < 8; ++i) wr[i] = __ldg(wfrag + i * 32 + lane);
    }
    // B: channel gid % 4, window columns 2 tig and 2 tig + 1.
    const __nv_bfloat16* yb = ys + (gid & 3) * S::kPlane + 2 * tig;
    for (int task = warp; task < S::kHalf; task += S::kWarps) {
        const int q = min(task + S::kHalf * (gid >> 2), kTiles - 1);
        const int ty = q / S::kMTiles, tx = q - ty * S::kMTiles;
        const __nv_bfloat16* yt = yb + 2 * ty * S::kInG + 2 * tx;
        float dh[4] = {}, dl[4] = {};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(yt + 2 * s * S::kInG),
                                   *reinterpret_cast<const uint32_t*>(yt + (2 * s + 1) * S::kInG)};
            const uint4 h4 = kWRegs ? wr[s] : __ldg(wfrag + s * 32 + lane);
            const uint4 l4 = kWRegs ? wr[4 + s] : __ldg(wfrag + (4 + s) * 32 + lane);
            const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w}, al[4] = {l4.x, l4.y, l4.z, l4.w};
            mma_bf16(dh, ah, b);
            mma_bf16(dl, al, b);
        }
        // D rows gid, gid + 8: points (gid / 4 + 2h, gid % 4) of the M-tile;
        // columns 2 tig, 2 tig + 1: channels 2 (tig % 2) and + 1 of M-tile tig / 2.
        const int qd = task + S::kHalf * (tig >> 1);
        if (qd < kTiles) {
            const int i = 4 * (qd / S::kMTiles) + (gid >> 2);
            const int j = 4 * (qd % S::kMTiles) + (gid & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (i + 2 * h < S::kSpan && j < S::kSpan) {
                    float2* m = reinterpret_cast<float2*>(
                        buf0 + (i + 2 * h) * S::kMPitch + j * kCg + 2 * (tig & 1));
                    float2 v = *m;
                    v.x *= dh[2 * h] + dl[2 * h];
                    v.y *= dh[2 * h + 1] + dl[2 * h + 1];
                    *m = v;
                }
            }
        }
    }
}

// A pixel's slice of dx: one 16-byte (fp32) or 8-byte (bf16) store where it
// is aligned and whole, else one store per channel.
__device__ __forceinline__ void store_slice(float* p, const float4& v, int nc) {
    if (nc == kCg && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        *reinterpret_cast<float4*>(p) = v;
        return;
    }
    const float f[kCg] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kCg; ++k) {
        if (k < nc) p[k] = f[k];
    }
}
__device__ __forceinline__ void store_slice(__nv_bfloat16* p, const float4& v, int nc) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    if (nc == kCg && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        uint2 bits;
        bits.x = *reinterpret_cast<const uint32_t*>(&lo);
        bits.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p) = bits;
        return;
    }
    const __nv_bfloat16 b[kCg] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int k = 0; k < kCg; ++k) {
        if (k < nc) p[k] = b[k];
    }
}

// One group of an up pass: kUpOut up-grid samples from RUN inputs
// src[q * stride], the first on a stuffed pixel. Sample m takes phase
// p = -m mod U, i.e. taps f[p + U*q] on inputs ceil(m / U) + q; the result is
// added to acc.
template <int U, int TU, int RUN>
__device__ __forceinline__ void up_run(const float* f, const float* src, int stride,
                                       float (&acc)[kUpOut]) {
    float v[RUN];
#pragma unroll
    for (int q = 0; q < RUN; ++q) v[q] = src[q * stride];
#pragma unroll
    for (int m = 0; m < kUpOut; ++m) {
        const int p = (U - m % U) % U, off = (m + p) / U;
        float a = acc[m];
#pragma unroll
        for (int q = 0; q < TU / U; ++q) a = fmaf(f[p + U * q], v[off + q], a);
        acc[m] = a;
    }
}

// acc[r] += sum_k f[k] * src[(U*r + k) * stride], r < R: R outputs of a
// stride-U FIR from one register-resident run of U*(R-1) + TU samples.
template <int U, int TU, int R>
__device__ __forceinline__ void down_run(const float* f, const float* src, int stride,
                                         float (&acc)[R]) {
    float v[U * (R - 1) + TU];
#pragma unroll
    for (int q = 0; q < U * (R - 1) + TU; ++q) v[q] = src[q * stride];
#pragma unroll
    for (int k = 0; k < TU; ++k) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(f[k], v[U * r + k], acc[r]);
    }
}

// The shape of an instantiation: bf16 with a radial fd takes the tensor cores.
template <typename T, int U, int TU, int TD, bool RADIAL>
using ShapeOf = Shape<U, TU, TD, RADIAL, RADIAL && std::is_same<T, __nv_bfloat16>::value>;

template <typename T, int U, int TU, int TD, bool RADIAL>
__global__ void __launch_bounds__((ShapeOf<T, U, TU, TD, RADIAL>::kThreads),
                                  (ShapeOf<T, U, TU, TD, RADIAL>::kMinBlocks))
flrelu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ bias, const uint4* __restrict__ wfrag,
                  T* __restrict__ dx, const __grid_constant__ Geometry g,
                  const __grid_constant__ Taps taps) {
    using S = ShapeOf<T, U, TU, TD, RADIAL>;
    constexpr bool kMma = S::kMma;
    constexpr int kThreads = S::kThreads;
    extern __shared__ __align__(16) float smem[];
    float* buf0 = smem;                         // x tile; the mask, then dA; the dx tile
    float* buf1 = smem + S::kBuf0;              // dy tile (fp32, or kMma: bf16 planes)
    float* buf2 = smem + S::kBuf0 + S::kBuf1;   // W-upsampled rows, then W-downsampled rows

    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * kCg;
    const int tile_y = blockIdx.y / g.tiles_w;
    const int tile_x = blockIdx.y - tile_y * g.tiles_w;
    const int n = blockIdx.z;
    const int iy0 = tile_y * S::kT, ix0 = tile_x * S::kT;  // dx tile origin

    // Up-grid sample U*i0 + j of the backward frame is the forward's A at
    // stuffed x index base + j, base = U*i0 - (TU-1); the up passes start at
    // j = -e, the last stuffed pixel at or before j = 0, input pixel
    // (base - e) / U. For G the stuffed dy index is U*i0 - pp0 + j.
    const int base_ay = U * iy0 - (TU - 1), base_ax = U * ix0 - (TU - 1);
    const int e_ay = base_ay & (U - 1), e_ax = base_ax & (U - 1);
    const int ia_y = (base_ay - e_ay) >> S::kLog2U, ia_x = (base_ax - e_ax) >> S::kLog2U;
    const int base_gy = U * iy0 - g.ppy0, base_gx = U * ix0 - g.ppx0;
    const int e_gy = base_gy & 1, e_gx = base_gx & 1;
    const int ig_y = (base_gy - e_gy) >> 1, ig_x = (base_gx - e_gx) >> 1;

    // 1. Both input tiles, [kIn][kIn][kCg] each: x + bias on real pixels into
    //    buf0, dy into buf1; the padding stays zero.
    load_tile<kThreads, S::kInA, S::kXPitch>(x, bias, buf0, n, g.h, g.w, g.c, c0, ia_y, ia_x,
                                             g.n);
    if constexpr (kMma) {
        load_tile_planes<kThreads, S::kInG, S::kPlane>(
            dy, reinterpret_cast<__nv_bfloat16*>(buf1), n, g.yh, g.yw, g.c, c0, ig_y, ig_x, g.n);
    } else {
        load_tile<kThreads, S::kInG, S::kYPitch>(dy, static_cast<const float*>(nullptr), buf1, n,
                                                 g.yh, g.yw, g.c, c0, ig_y, ig_x, g.n);
    }
    __syncthreads();

    // 2. A: up-FIR along W into buf2[row][j][c]; lanes over (c, row).
    for (int idx = tid; idx < S::kInA * S::kGroupsA * kCg; idx += kThreads) {
        const int c = idx % kCg, row = (idx / kCg) % S::kInA, grp = idx / (kCg * S::kInA);
        float acc[kUpOut] = {};
        up_run<U, TU, S::kRunA>(
            taps.fu_a, buf0 + row * S::kXPitch + S::kStepsA * grp * kCg + c, kCg, acc);
#pragma unroll
        for (int m = 0; m < kUpOut; ++m) {
            const int j = -e_ax + kUpOut * grp + m;
            if (j >= 0 && j < S::kSpan) buf2[row * S::kT1Pitch + j * kCg + c] = acc[m];
        }
    }
    __syncthreads();

    // 3. A: up-FIR along H, then the mask into buf0[i][j][c]; lanes over (c, j).
    for (int idx = tid; idx < S::kSpan * S::kGroupsA * kCg; idx += kThreads) {
        const int c = idx % kCg, j = (idx / kCg) % S::kSpan, grp = idx / (kCg * S::kSpan);
        float acc[kUpOut] = {};
        up_run<U, TU, S::kRunA>(
            taps.fu_a, buf2 + S::kStepsA * grp * S::kT1Pitch + j * kCg + c, S::kT1Pitch, acc);
#pragma unroll
        for (int m = 0; m < kUpOut; ++m) {
            const int i = -e_ay + kUpOut * grp + m;
            const float a = acc[m];
            const float pre = (a >= 0.f ? a : a * g.slope) * g.gain;
            float f = (a >= 0.f ? 1.f : g.slope) * g.point_gain;
            if (fabsf(pre) > g.clamp) f = 0.f;
            if (i >= 0 && i < S::kSpan) buf0[i * S::kMPitch + j * kCg + c] = f;
        }
    }
    __syncthreads();

    // 4. G = x2 up-FIR of dy with fd (correlation); buf0 *= G.
    if constexpr (kMma) {
        mma_up<S>(reinterpret_cast<const __nv_bfloat16*>(buf1), wfrag, buf0);
    } else if constexpr (RADIAL) {
        // Lanes over (c, row pair); each thread computes 8 samples of row
        // 2k and 8 of row 2k+1, so the row's tap phase is warp-uniform.
        for (int idx = tid; idx < (S::kSpan / 2) * S::kGroupsG * kCg; idx += kThreads) {
            const int c = idx % kCg, k = (idx / kCg) % (S::kSpan / 2);
            const int grp = idx / (kCg * (S::kSpan / 2));
#pragma unroll
            for (int par = 0; par < 2; ++par) {
                const int i = 2 * k + par, r = i + e_gy;  // r: stuffed row from the tile's start
                const int p = r & 1, row0 = (r + p) >> 1;
                float acc[kUpOut] = {};
#pragma unroll
                for (int q = 0; q < TD / 2; ++q) {
                    up_run<2, TD, S::kRunG>(
                        taps.fd + (p + 2 * q) * TD,
                        buf1 + (row0 + q) * S::kYPitch + S::kStepsG * grp * kCg + c, kCg, acc);
                }
#pragma unroll
                for (int m = 0; m < kUpOut; ++m) {
                    const int j = -e_gx + kUpOut * grp + m;
                    if (j >= 0 && j < S::kSpan) buf0[i * S::kMPitch + j * kCg + c] *= acc[m];
                }
            }
        }
    } else {
        // Along W into buf2[row][j][c]; lanes over (c, row).
        for (int idx = tid; idx < S::kInG * S::kGroupsG * kCg; idx += kThreads) {
            const int c = idx % kCg, row = (idx / kCg) % S::kInG, grp = idx / (kCg * S::kInG);
            float acc[kUpOut] = {};
            up_run<2, TD, S::kRunG>(
                taps.fd, buf1 + row * S::kYPitch + S::kStepsG * grp * kCg + c, kCg, acc);
#pragma unroll
            for (int m = 0; m < kUpOut; ++m) {
                const int j = -e_gx + kUpOut * grp + m;
                if (j >= 0 && j < S::kSpan) buf2[row * S::kT1Pitch + j * kCg + c] = acc[m];
            }
        }
        __syncthreads();
        // Along H; lanes over (c, j).
        for (int idx = tid; idx < S::kSpan * S::kGroupsG * kCg; idx += kThreads) {
            const int c = idx % kCg, j = (idx / kCg) % S::kSpan, grp = idx / (kCg * S::kSpan);
            float acc[kUpOut] = {};
            up_run<2, TD, S::kRunG>(
                taps.fd, buf2 + S::kStepsG * grp * S::kT1Pitch + j * kCg + c, S::kT1Pitch, acc);
#pragma unroll
            for (int m = 0; m < kUpOut; ++m) {
                const int i = -e_gy + kUpOut * grp + m;
                if (i >= 0 && i < S::kSpan) buf0[i * S::kMPitch + j * kCg + c] *= acc[m];
            }
        }
    }
    __syncthreads();

    // 5. Stride-U down-FIR along W into buf2[i][ox][c]; lanes over (c, i).
    for (int idx = tid; idx < S::kSpan * (S::kT / S::kR) * kCg; idx += kThreads) {
        const int c = idx % kCg, i = (idx / kCg) % S::kSpan;
        const int ox = idx / (kCg * S::kSpan) * S::kR;
        float acc[S::kR] = {};
        down_run<U, TU, S::kR>(taps.fu_d, buf0 + i * S::kMPitch + U * ox * kCg + c, kCg, acc);
#pragma unroll
        for (int r = 0; r < S::kR; ++r) buf2[i * S::kDPitch + (ox + r) * kCg + c] = acc[r];
    }
    __syncthreads();

    // 6. Along H into the dx tile buf0[oy][ox][c]; lanes over (c, ox), each
    //    thread computes oy .. oy + kR - 1. Then one thread per pixel stores
    //    its slice.
    for (int idx = tid; idx < S::kT * (S::kT / S::kR) * kCg; idx += kThreads) {
        const int c = idx % kCg, ox = (idx / kCg) % S::kT, oy = idx / (kCg * S::kT) * S::kR;
        float acc[S::kR] = {};
        down_run<U, TU, S::kR>(taps.fu_d, buf2 + U * oy * S::kDPitch + ox * kCg + c,
                               S::kDPitch, acc);
#pragma unroll
        for (int r = 0; r < S::kR; ++r) buf0[((oy + r) * S::kT + ox) * kCg + c] = acc[r];
    }
    __syncthreads();
    if (tid < S::kT * S::kT) {
        const int oy = tid / S::kT, ox = tid % S::kT, gy = iy0 + oy, gx = ix0 + ox;
        if (gy < g.h && gx < g.w) {
            store_slice(dx + ((size_t(n) * g.h + gy) * g.w + gx) * g.c + c0,
                        *reinterpret_cast<const float4*>(buf0 + tid * kCg), min(kCg, g.c - c0));
        }
    }
}

template <typename T, int U, int TU, int TD, bool RADIAL>
int launch(const void* dy, const void* x, const void* bias, const void* wfrag, void* dx,
           const Geometry& g, const Taps& taps, cudaStream_t stream) {
    using S = ShapeOf<T, U, TU, TD, RADIAL>;
    auto kernel = flrelu_bwd_kernel<T, U, TU, TD, RADIAL>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmemBytes));
    if (err != cudaSuccess) return int(err);
    const int tiles_h = (g.h + S::kT - 1) / S::kT;
    const int tiles_w = (g.w + S::kT - 1) / S::kT;
    Geometry geo = g;
    geo.tiles_w = tiles_w;
    dim3 grid(unsigned((g.c + kCg - 1) / kCg), unsigned(tiles_h * tiles_w), unsigned(g.n));
    kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(bias),
        static_cast<const uint4*>(wfrag), static_cast<T*>(dx), geo, taps);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* dy, const void* x, const void* bias, const void* wfrag, void* dx,
             const Geometry& g, const Taps& taps, int up, int radial, cudaStream_t s) {
    if (up == 2) {
        return radial ? launch<T, 2, 12, 12, true>(dy, x, bias, wfrag, dx, g, taps, s)
                      : launch<T, 2, 12, 12, false>(dy, x, bias, wfrag, dx, g, taps, s);
    }
    return radial ? launch<T, 4, 24, 12, true>(dy, x, bias, wfrag, dx, g, taps, s)
                  : launch<T, 4, 24, 12, false>(dy, x, bias, wfrag, dx, g, taps, s);
}

template <typename T>
size_t smem_bytes(int up, int radial) {
    if (up == 2) {
        return radial ? ShapeOf<T, 2, 12, 12, true>::kSmemBytes
                      : ShapeOf<T, 2, 12, 12, false>::kSmemBytes;
    }
    return radial ? ShapeOf<T, 4, 24, 12, true>::kSmemBytes
                  : ShapeOf<T, 4, 24, 12, false>::kSmemBytes;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at up factor 2 or 4, radial fd or not,
// fp32 (bf16 = 0) or bf16 input.
size_t sg3_flrelu_bwd_smem_bytes(int up, int radial, int bf16) {
    return bf16 ? smem_bytes<__nv_bfloat16>(up, radial) : smem_bytes<float>(up, radial);
}

// dy, x, dx: NHWC device tensors of one dtype, 0 = float32, 1 = bfloat16.
// bias: float32 [c] on the device (the values the forward added). fu, fd:
// host float32 taps as given (fu 1-D; fd 1-D, or 2-D row-major when radial).
// wfrag: for bf16 with a radial fd, the tensor-core dy up pass's operand W
// as A fragments, int32 [2 (hi, lo)][4][32][4] on the device, 16-byte
// aligned, for the stuffing parity (ppy0 % 2, ppx0 % 2)
// (flrelu_cuda.mma_up_operand_on); otherwise unused. Supported: up 2 with 12
// fu taps or up 4 with 24, and 12 fd taps per axis. Returns the cudaError_t
// of the launch (0 on success).
int sg3_flrelu_bwd(const void* dy, const void* x, const void* bias, const float* fu,
                   const float* fd, const void* wfrag, void* dx, int dtype, int n, int h, int w,
                   int c, int yh, int yw, int up, int tu, int td, int radial, int ppy0,
                   int ppx0, float gain, float slope, float clamp, void* stream) {
    if (!((up == 2 && tu == 12) || (up == 4 && tu == 24)) || td != 12 ||
        (dtype != 0 && dtype != 1) ||
        (dtype == 1 && radial && (wfrag == nullptr || uintptr_t(wfrag) % 16 != 0))) {
        return int(cudaErrorInvalidValue);
    }
    Geometry g{n, h, w, c, yh, yw, ppy0, ppx0, gain, slope, clamp,
               gain * float(up * up), 0};
    Taps taps{};
    for (int i = 0; i < tu; ++i) {
        taps.fu_a[i] = fu[tu - 1 - i] * float(up);
        taps.fu_d[i] = fu[i];
    }
    for (int i = 0; i < (radial ? td * td : td); ++i) taps.fd[i] = fd[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? dispatch<float>(dy, x, bias, wfrag, dx, g, taps, up, radial, s)
                      : dispatch<__nv_bfloat16>(dy, x, bias, wfrag, dx, g, taps, up, radial, s);
}

}  // extern "C"
