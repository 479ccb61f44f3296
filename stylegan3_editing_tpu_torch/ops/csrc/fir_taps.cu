// Two-axis valid FIR as tap chains on the CUDA cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_vpu` of the banded-FIR probe
// (scripts/exp_mxu_down.py:56). For a plane p [Qh, Qw, C] (fp32 or bf16)
// and fp32 taps tw [Tw], th [Th] it computes, with p upcast to fp32,
//   t[q, j, c] = sum_k tw[k] * p[q, j + k, c]     (the W chain, first)
//   o[i, j, c] = sum_k th[k] * t[i + k, j, c]     (then the H chain)
// the fp32 valid output [Qh - Th + 1, Qw - Tw + 1, C], each chain summed in
// tap order as the TPU kernel does. The tap counts are runtime arguments.
//
// Bound on the card: at 12 taps the two chains do ~50 useful FLOP per
// output against 8 (fp32) or 6 (bf16) bytes of input and output, under the
// card's ridge of ~20 FLOP/B, so the floor is bytes(in + out) / 3.35 TB/s.
// What the design does about it:
// - channels run on neighbouring threads (the layout is HWC), so a warp's
//   load or store of one pixel is 32 contiguous channels;
// - a block of 16 warps holds a tile of kTi x kTj outputs of kCb channels;
//   the W chain of the tile's kTi + Th - 1 input rows goes to shared memory
//   and the H chain reads it from there, so only the tile's halo is read
//   twice (from L2) and p and o cross device memory once. Two blocks fit an
//   SM (88 KB each at 12 taps; the launch bounds cap registers at 64 so
//   that they do);
// - both chains are register-blocked: a thread slides a window of kR = 16
//   samples along its run (a whole tile row of the W chain) and feeds kR
//   outputs from each sample it loads, so a tap costs kR FMAs, one load and
//   one uniform read of the tap (the taps ride in the kernel's parameter
//   space); the tap loop is unrolled by kR, which turns the window's shifts
//   into register renames.
// TMA and pipelining are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfir_taps.so fir_taps.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kCb = 32;  // channels per block, one per lane
constexpr int kTj = 16;  // output columns per tile
constexpr int kTi = 32;  // output rows per tile
constexpr int kR = 16;   // outputs per thread along a chain
constexpr int kMaxTaps = 64;

struct Geometry {
    int qw, c;           // input plane [qh, qw, c]
    int out_h, out_w;    // output [out_h, out_w, c]
    int tiles_w;
};

struct Taps {
    float w[kMaxTaps], h[kMaxTaps];
    int tw, th;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// acc[r] = sum_k f[k] * src[(r + k) * stride] for r < kR, k < nt, in tap
// order; samples at or past `avail` read as zero.
template <typename T>
__device__ __forceinline__ void chain(const float* f, int nt, const T* src, size_t stride,
                                      int avail, float (&acc)[kR]) {
    avail = min(avail, kR + nt - 1);
    float w[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        w[r] = r < avail ? load_f32(src + r * stride) : 0.f;
        acc[r] = 0.f;
    }
#pragma unroll (kR)
    for (int k = 0; k < nt; ++k) {
        const float fk = f[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = fmaf(fk, w[r], acc[r]);
#pragma unroll
        for (int r = 0; r + 1 < kR; ++r) w[r] = w[r + 1];
        w[kR - 1] = k + kR < avail ? load_f32(src + (k + kR) * stride) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fir_taps_kernel(const T* __restrict__ p, float* __restrict__ out,
                const __grid_constant__ Geometry g, const __grid_constant__ Taps taps) {
    extern __shared__ float t_s[];  // W chain of the tile: [rows][kTj][kCb]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile_i = blockIdx.x / g.tiles_w, tile_j = blockIdx.x - tile_i * g.tiles_w;
    const int i0 = tile_i * kTi, j0 = tile_j * kTj;
    const int ch = blockIdx.y * kCb + lane;
    const bool ch_ok = ch < g.c;
    const int out_rows = min(kTi, g.out_h - i0);
    const int rows = out_rows + taps.th - 1;  // input rows the tile needs

    // 1. W chain: warps over (row, run of kR columns), lanes over channels.
    for (int item = warp; item < rows * (kTj / kR); item += kWarps) {
        const int row = item / (kTj / kR), jr = item % (kTj / kR) * kR;
        if (j0 + jr >= g.out_w) continue;
        float acc[kR];
        chain(taps.w, taps.tw, p + (size_t(i0 + row) * g.qw + j0 + jr) * g.c + ch, size_t(g.c),
              ch_ok ? g.qw - (j0 + jr) : 0, acc);
#pragma unroll
        for (int r = 0; r < kR; ++r) t_s[(row * kTj + jr + r) * kCb + lane] = acc[r];
    }
    __syncthreads();

    // 2. H chain from shared memory: warps over (column, run of kR rows).
    for (int item = warp; item < kTj * (kTi / kR); item += kWarps) {
        const int j = item % kTj, ir = item / kTj * kR;
        if (j0 + j >= g.out_w || ir >= out_rows) continue;
        float acc[kR];
        chain(taps.h, taps.th, t_s + (ir * kTj + j) * kCb + lane, size_t(kTj * kCb),
              rows - ir, acc);
        if (!ch_ok) continue;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            if (ir + r < out_rows)
                out[(size_t(i0 + ir + r) * g.out_w + j0 + j) * g.c + ch] = acc[r];
        }
    }
}

size_t smem_bytes(int th) { return sizeof(float) * size_t(kTi + th - 1) * kTj * kCb; }

template <typename T>
int launch(const void* p, void* out, const Geometry& g, const Taps& taps, cudaStream_t stream) {
    auto kernel = fir_taps_kernel<T>;
    const size_t smem = smem_bytes(taps.th);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    const int tiles_h = (g.out_h + kTi - 1) / kTi;
    dim3 grid(unsigned(tiles_h * g.tiles_w), unsigned((g.c + kCb - 1) / kCb));
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(p),
                                             static_cast<float*>(out), g, taps);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for th taps along H.
size_t sg3_fir_taps_smem_bytes(int th) { return smem_bytes(th); }

// p: [qh, qw, c] device tensor, dtype 0 = float32, 1 = bfloat16. taps_w,
// taps_h: host float32 taps (tw <= qw and th <= qh, at most 64 each). out:
// float32 [qh - th + 1, qw - tw + 1, c] on the device. Returns the
// cudaError_t of the launch (0 on success).
int sg3_fir_taps(const void* p, const float* taps_w, const float* taps_h, void* out,
                 int dtype, int qh, int qw, int c, int tw, int th, void* stream) {
    if (tw < 1 || th < 1 || tw > kMaxTaps || th > kMaxTaps || qw < tw || qh < th || c < 1 ||
        (dtype != 0 && dtype != 1)) {
        return int(cudaErrorInvalidValue);
    }
    Geometry g{qw, c, qh - th + 1, qw - tw + 1, 0};
    g.tiles_w = (g.out_w + kTj - 1) / kTj;
    Taps taps{};
    for (int k = 0; k < tw; ++k) taps.w[k] = taps_w[k];
    for (int k = 0; k < th; ++k) taps.h[k] = taps_h[k];
    taps.tw = tw;
    taps.th = th;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch<float>(p, out, g, taps, s)
                      : launch<__nv_bfloat16>(p, out, g, taps, s);
}

}  // extern "C"
