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
// or 24 (separable fd) FMA per output, in fp32 on the CUDA cores; on SG3-R
// they are the larger term. What the design does about it:
// - the geometry (taps, tile, channel group) is compile-time, so every tap
//   loop unrolls and the index arithmetic folds;
// - the taps ride in the kernel's parameter space (__grid_constant__), so a
//   down-pass FMA reads its tap as a constant operand, not from shared memory;
// - the up passes touch only the non-zero (every u-th) taps, and are
//   register-blocked: a thread loads a run of 8/u + tu/u inputs once and
//   computes 8 up-grid samples from it;
// - the down pass is register-blocked the same way: a thread keeps a run of
//   2*8+td-2 up-grid values in registers and feeds 8 outputs from it;
// - the row pitches are padded so a warp's 32 lanes hit 32 banks.
// Tensor cores, TMA and pipelining are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libflrelu.so filtered_lrelu_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // output tile side
constexpr int kCg = 8;     // channels per block, the fastest index in shared memory
constexpr int kR = 8;      // outputs per thread along the blocked axis of the down pass
constexpr int kUpOut = 8;  // up-grid outputs per thread in each up pass
constexpr int kMaxTu = 24, kMaxTd = 12;

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

template <typename T, int U, int TU, int TD, bool RADIAL>
__global__ void __launch_bounds__(kThreads)
flrelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                  T* __restrict__ out, const __grid_constant__ Geometry g,
                  const __grid_constant__ Taps taps) {
    using S = Shape<U, TU, TD>;
    extern __shared__ float smem[];
    float* buf0 = smem;             // input tile, then the activated up grid
    float* buf1 = smem + S::kBuf0;  // W-upsampled rows, then W-downsampled rows

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

    // 3. Up-FIR along H, then lrelu * gain and clamp: buf0[i][j][c]. Lanes
    //    run over (c, j).
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
            if (i >= 0 && i < S::kSpan) buf0[i * S::kAPitch + j * kCg + c] = v;
        }
    }
    __syncthreads();

    // 4-5. Stride-2 down-FIR, kR outputs per thread, and store.
    auto store = [&](int oy, int ox, int c, float v) {
        const int gy = oy0 + oy, gx = ox0 + ox, ch = c0 + c;
        if (gy < g.out_h && gx < g.out_w && ch < g.c)
            store_f32(out + ((size_t(n) * g.out_h + gy) * g.out_w + gx) * g.c + ch, v);
    };
    if constexpr (RADIAL) {
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
int launch(const void* x, const void* bias, void* out, const Geometry& g,
           const Taps& taps, cudaStream_t stream) {
    using S = Shape<U, TU, TD>;
    auto kernel = flrelu_fwd_kernel<T, U, TU, TD, RADIAL>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmemBytes));
    if (err != cudaSuccess) return int(err);
    const int tiles_h = (g.out_h + kTile - 1) / kTile;
    dim3 grid(unsigned(tiles_h * g.tiles_w), unsigned((g.c + kCg - 1) / kCg), unsigned(g.n));
    kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(bias), static_cast<T*>(out),
        g, taps);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* bias, void* out, const Geometry& g,
             const Taps& taps, int up, int radial, cudaStream_t s) {
    if (up == 2) {
        return radial ? launch<T, 2, 12, 12, true>(x, bias, out, g, taps, s)
                      : launch<T, 2, 12, 12, false>(x, bias, out, g, taps, s);
    }
    return radial ? launch<T, 4, 24, 12, true>(x, bias, out, g, taps, s)
                  : launch<T, 4, 24, 12, false>(x, bias, out, g, taps, s);
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
// up gain folded in; fd 1-D, or 2-D row-major when radial). Supported: up 2
// with 12 fu taps or up 4 with 24, and 12 fd taps per axis.
// Returns the cudaError_t of the launch (0 on success).
int sg3_flrelu_fwd(const void* x, const void* bias, const float* fu, const float* fd,
                   void* out, int dtype, int n, int h, int w, int c, int out_h,
                   int out_w, int up, int tu, int td, int radial, int py0, int px0,
                   float gain, float slope, float clamp, void* stream) {
    if (!((up == 2 && tu == 12) || (up == 4 && tu == 24)) || td != 12 ||
        (dtype != 0 && dtype != 1)) {
        return int(cudaErrorInvalidValue);
    }
    Geometry g{n, h, w, c, out_h, out_w, py0, px0, gain, slope, clamp,
               (out_w + kTile - 1) / kTile};
    Taps taps{};
    for (int i = 0; i < tu; ++i) taps.fu[i] = fu[i];
    for (int i = 0; i < (radial ? td * td : td); ++i) taps.fd[i] = fd[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? dispatch<float>(x, bias, out, g, taps, up, radial, s)
                      : dispatch<__nv_bfloat16>(x, bias, out, g, taps, up, radial, s);
}

}  // extern "C"
