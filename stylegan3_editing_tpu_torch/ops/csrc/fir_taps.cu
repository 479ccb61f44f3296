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
// What the design does about it: the plane is read once, with rows always
// in flight, and a block's threads work on their own with one barrier a row.
// - A block owns 64 bytes of each pixel (a group of 16 fp32 or 32 bf16
//   channels: whole 32-byte sectors), a band of output rows and a strip of
//   at most kThreads / 4 output columns, and walks the band's input rows
//   from top to bottom once: a thread owns one output column and one
//   16-byte slice of its pixels (4 fp32 or 8 bf16 channels, one shared
//   read a tap), and the block is sized to its strip (96 threads for the
//   probe's strips of 22, 22 and 21 columns).
// - Input rows arrive by TMA (cp.async.bulk.tensor): thread 0 copies one
//   row of the strip, its channels by strip_w + Tw - 1 pixels (zeros
//   past the plane), into a ring of kStages 128-byte-aligned row stages in
//   shared memory, each with an mbarrier that the copy completes; rows
//   q + 1 .. q + kStages - 1 are in flight while row q is used. No other
//   thread issues copies: on the H100, 16-byte cp.async copies issued by
//   every thread stalled the threads for 35-40 % of their cycles. Where a
//   pixel's channels are not whole aligned 16-byte slices (C * size % 16 !=
//   0, or a plane off a 16-byte boundary), the block fills the same ring
//   with element loads.
// - For each row a thread sums its column's W chain from the stage (Tw
//   shared reads of its slice) into t, then feeds t to the H chains of the
//   Th output rows that need it. With Th = kRegTh (the probe's 12) their
//   running sums stay in registers, a ring of Th slices rotated by the row
//   index (a branch on q % Th makes every index static): output row i
//   takes th[k] * t[i + k] at row i + k, so its sum runs in tap order, and
//   it is stored as soon as row i + Th - 1 has landed. For other Th the
//   thread keeps its own ring of Th values of t in shared memory and sums
//   output row i from it once row i + Th - 1 has landed.
// - The time follows the block-rows an SM holds at once: the launch bounds
//   hold an fp32 thread to 85 registers (48 running sums), so 8 blocks share
//   an SM at the probe's shape, and a bf16 thread to 128 (96 sums, 5
//   blocks, each with twice the channels). Fewer registers spill and lose.
// - The host sizes the plan from the shape (`make_plan`): strips of at
//   most kThreads / 4 columns whose stages (and ring of t) fit kSmemTarget,
//   each with a Tw - 1 halo of input columns; and, where the channel groups
//   and strips give too few blocks to fill the card, row bands with a
//   Th - 1 halo of input rows. Bands and strips split the output evenly.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfir_taps.so fir_taps.cu

#include <cuda.h>  // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // at most, a block: a thread per (column, slice) of a strip
constexpr int kPixelBytes = 64;      // of a pixel, a block's channels: 16 fp32 or 32 bf16
constexpr int kSlices = 4;           // 16-byte slices of those: threads per column
constexpr int kStages = 8;           // input rows in the ring
constexpr int kRegTh = 12;           // H taps whose running sums stay in registers
constexpr int kMaxTaps = 64;
constexpr int kSmemTarget = 113'664;  // bytes per block: two blocks share an SM
constexpr int kFillBlocks = 4 * 132;  // blocks that fill an H100 four deep
constexpr int kMinBand = 4;           // output rows of a band, at least (unless fewer)
constexpr int kBarBytes = 128;        // the stages' mbarriers, before the 128-byte-aligned stages

struct Plan {
    int qw, c, out_h, out_w;
    int strips, bands;  // column strips and row bands of the output, split evenly
    int strip_w;        // widest strip
    int threads;        // the block: strip_w * kSlices threads, whole warps
    int pitch;          // bytes of a stage: strip_w + tw - 1 pixels, to 128 bytes
    int vec;            // whole aligned 16-byte channel slices: rows by TMA
    int vec_out;        // float4 stores of whole 4-channel slices
};

// A thread's 16-byte slice of a pixel, widened to fp32: 4 fp32 or 8 bf16 channels.
template <typename T>
struct Slice {
    static constexpr int kN = 16 / (4 * int(sizeof(T)));  // float4s: 1 or 2
    float4 q[kN];
};

// Resident blocks per SM that the registers must allow: fp32 holds 48 running
// sums a thread (<= 85 registers), bf16 96 (<= 128).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 4;

struct Taps {
    float w[kMaxTaps], h[kMaxTaps];
    int tw, th;
};

__device__ __forceinline__ void fma4(float4& a, float f, const float4& x) {
    a.x = fmaf(f, x.x, a.x);
    a.y = fmaf(f, x.y, a.y);
    a.z = fmaf(f, x.z, a.z);
    a.w = fmaf(f, x.w, a.w);
}

template <typename T>
__device__ __forceinline__ Slice<T> zero_slice() {
    Slice<T> v;
#pragma unroll
    for (int h = 0; h < Slice<T>::kN; ++h) v.q[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    return v;
}

template <typename T>
__device__ __forceinline__ void fma_slice(Slice<T>& a, float f, const Slice<T>& x) {
#pragma unroll
    for (int h = 0; h < Slice<T>::kN; ++h) fma4(a.q[h], f, x.q[h]);
}

// One 16-byte read of a pixel's slice, widened to fp32 in channel order (a
// bf16 channel is the high half of its fp32 value).
__device__ __forceinline__ Slice<float> load_slice(const float* s) {
    return Slice<float>{{*reinterpret_cast<const float4*>(s)}};
}
__device__ __forceinline__ Slice<__nv_bfloat16> load_slice(const __nv_bfloat16* s) {
    const uint4 raw = *reinterpret_cast<const uint4*>(s);
    return Slice<__nv_bfloat16>{
        {make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u)),
         make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                     __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u))}};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Arm a stage's mbarrier for `bytes` and copy the box at (x, y, z) of the
// tensor map into the stage; the copy completes the barrier's phase.
__device__ __forceinline__ void tma_row(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int bytes, int x, int y, int z) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4}], [%5];"
                 ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
                 "r"(z), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
                     "selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// First element of part k of n of [0, len): the parts differ by one at most.
__host__ __device__ __forceinline__ int split_at(int k, int n, int len) {
    return int((long long)k * len / n);
}

// Row q = u (mod kTh) of the H chains in registers: acc[s] holds output row
// i = s (mod kTh), which takes tap q - i. Output row q - kTh + 1 is then
// whole: it is returned and its slot cleared for row q + 1.
template <int kTh, int u, typename T>
__device__ __forceinline__ Slice<T> h_row(Slice<T> (&acc)[kTh], const float (&th)[kTh],
                                          const Slice<T>& t) {
#pragma unroll
    for (int k = 0; k < kTh; ++k) fma_slice(acc[(u - k + kTh) % kTh], th[k], t);
    const Slice<T> done = acc[(u + 1) % kTh];
    acc[(u + 1) % kTh] = zero_slice<T>();
    return done;
}

template <int kTh, typename T, int u = kTh - 1>
__device__ __forceinline__ Slice<T> h_row_at(int q_mod, Slice<T> (&acc)[kTh],
                                             const float (&th)[kTh], const Slice<T>& t) {
    if constexpr (u == 0) {
        return h_row<kTh, 0>(acc, th, t);
    } else {
        return q_mod == u ? h_row<kTh, u>(acc, th, t)
                          : h_row_at<kTh, T, u - 1>(q_mod, acc, th, t);
    }
}

// kTh = kRegTh: the H chains' running sums in registers; kTh = 0: any Th,
// each thread's ring of t in shared memory.
template <typename T, int kTh>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
fir_taps_kernel(const T* __restrict__ p, float* __restrict__ out,
                const __grid_constant__ Plan g, const __grid_constant__ Taps taps,
                const __grid_constant__ CUtensorMap rows_map) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int kCb = kPixelBytes / int(sizeof(T));  // channels per block
    constexpr int kSl = 16 / int(sizeof(T));           // channels per thread
    const int tid = threadIdx.x;
    const int strip = blockIdx.x % g.strips;
    const int band = (blockIdx.x / g.strips) % g.bands;
    const int c0 = blockIdx.x / (g.strips * g.bands) * kCb;
    const int j0 = split_at(strip, g.strips, g.out_w);
    const int cols = split_at(strip + 1, g.strips, g.out_w) - j0;  // output columns
    const int i0 = split_at(band, g.bands, g.out_h);
    const int out_rows = split_at(band + 1, g.bands, g.out_h) - i0;
    const int th = taps.th;
    const int rows = out_rows + th - 1;       // input rows the band reads
    const int cols_in = cols + taps.tw - 1;   // input columns the strip reads
    const int nch = min(kCb, g.c - c0);
    const int slice = tid % kSlices, j = tid / kSlices;  // this thread's slice and column
    const bool active = j < cols && kSl * slice < nch;
    const int pitch = g.pitch / int(sizeof(T));  // elements of a stage
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one mbarrier a stage
    T* stage = reinterpret_cast<T*>(smem + kBarBytes);
    // kTh = 0: each thread's ring of t, [th][g.strip_w * kSlices] slices.
    Slice<T>* tring = reinterpret_cast<Slice<T>*>(smem + kBarBytes + kStages * g.pitch);
    const int ring_w = g.strip_w * kSlices;
    const int box_bytes = (g.strip_w + taps.tw - 1) * kCb * int(sizeof(T));
    if (g.vec && tid == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // Row r of the band into stage r % kStages: one TMA copy of the strip's
    // box (thread 0), or element loads by every thread.
    auto fetch = [&](int r) {
        if (r >= rows) return;
        T* dst = stage + (r % kStages) * pitch;
        if (g.vec) {
            if (tid == 0) tma_row(dst, &rows_map, &bars[r % kStages], box_bytes, c0, j0, i0 + r);
            return;
        }
        const T* src = p + (size_t(i0 + r) * g.qw + j0) * g.c + c0;
        for (int k = tid; k < cols_in * kCb; k += g.threads) {
            const int px = k / kCb, e = k - px * kCb;
            dst[k] = e < nch ? src[size_t(px) * g.c + e] : T(0.f);
        }
    };

    constexpr int kRing = kTh > 0 ? kTh : 1;
    Slice<T> acc[kRing];
    float hk[kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
        acc[k] = zero_slice<T>();
        hk[k] = taps.h[k];
    }
    float* dst = out + (size_t(i0) * g.out_w + j0 + j) * g.c + c0 + kSl * slice;  // row i0
    const bool whole = g.vec_out && kSl * slice + kSl <= nch;

    for (int r = 0; r < kStages - 1; ++r) fetch(r);
    for (int q = 0; q < rows; ++q) {
        __syncthreads();  // everyone is done with row q - 1's stage (and sees element loads)
        fetch(q + kStages - 1);
        if (!active) continue;
        if (g.vec) mbar_wait(&bars[q % kStages], (q / kStages) & 1);  // row q has landed

        // W chain of row q at column j.
        const T* src = stage + (q % kStages) * pitch + j * kCb + kSl * slice;
        Slice<T> t = zero_slice<T>();
#pragma unroll 4
        for (int k = 0; k < taps.tw; ++k) fma_slice(t, taps.w[k], load_slice(src + k * kCb));

        // H chains: output row i = q - th + 1 is whole after row q.
        const int i = q - th + 1;
        Slice<T> o;
        if constexpr (kTh > 0) {
            o = h_row_at<kTh>(q % kTh, acc, hk, t);
        } else {
            tring[(q % th) * ring_w + tid] = t;
            if (i < 0) continue;
            o = zero_slice<T>();
            int slot = i % th;
            for (int k = 0; k < th; ++k) {
                fma_slice(o, taps.h[k], tring[slot * ring_w + tid]);
                slot = slot + 1 == th ? 0 : slot + 1;
            }
        }
        if (i < 0) continue;
        float* d = dst + size_t(i) * g.out_w * g.c;
#pragma unroll
        for (int h = 0; h < Slice<T>::kN; ++h) {
            if (whole) {
                *reinterpret_cast<float4*>(d + 4 * h) = o.q[h];
            } else {
                const float v[4] = {o.q[h].x, o.q[h].y, o.q[h].z, o.q[h].w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (kSl * slice + 4 * h + e < nch) d[4 * h + e] = v[e];
            }
        }
    }
}

bool valid(int qh, int qw, int c, int tw, int th, int dtype) {
    return tw >= 1 && th >= 1 && tw <= kMaxTaps && th <= kMaxTaps && qw >= tw && qh >= th &&
           c >= 1 && (dtype == 0 || dtype == 1);
}

// Bytes of a stage: strip_w + tw - 1 pixels of kPixelBytes, to 128 bytes.
int pitch_for(int strip_w, int tw) {
    return ((strip_w + tw - 1) * kPixelBytes + 127) / 128 * 128;
}

// The stages' mbarriers, the stages, and the threads' rings of th values of
// t where the H chains do not run in registers.
size_t smem_for(int strip_w, int tw, int th, int esize) {
    return kBarBytes + size_t(kStages) * pitch_for(strip_w, tw) +
           (th == kRegTh ? 0 : size_t(th) * strip_w * (kPixelBytes / esize) * sizeof(float));
}

Plan make_plan(int qh, int qw, int c, int tw, int th, int esize) {
    Plan g{qw, c, qh - th + 1, qw - tw + 1, 1, 1, 0, 0, 0, 0, 0};
    // The widest strip a block's threads cover whose shared memory fits kSmemTarget.
    int widest = kThreads / kSlices;
    while (widest > 1 && smem_for(widest, tw, th, esize) > size_t(kSmemTarget)) --widest;
    g.strips = (g.out_w + widest - 1) / widest;
    g.strip_w = (g.out_w + g.strips - 1) / g.strips;
    g.threads = (g.strip_w * kSlices + 31) / 32 * 32;
    g.pitch = pitch_for(g.strip_w, tw);
    // Row bands, where channel groups and strips give too few blocks.
    const long long cb = kPixelBytes / esize;  // channels per block
    const long long groups = (c + cb - 1) / cb;
    const long long want = (kFillBlocks + groups * g.strips - 1) / (groups * g.strips);
    const long long most = (g.out_h + kMinBand - 1) / kMinBand;
    g.bands = int(want < most ? want : most);
    return g;
}

template <typename T>
auto kernel_for(int th) {
    return th == kRegTh ? fir_taps_kernel<T, kRegTh> : fir_taps_kernel<T, 0>;
}

template <typename T>
int blocks_per_sm(const Plan& g, int tw, int th) {
    const auto kernel = kernel_for<T>(th);
    const size_t smem = smem_for(g.strip_w, tw, th, sizeof(T));
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, g.threads, smem);
    return err == cudaSuccess ? n : -int(err);
}

// The plane [qh][qw][c] as a tensor map whose box is one row of a strip:
// kPixelBytes of channels by strip_w + tw - 1 pixels (past the plane: zeros).
bool rows_map_for(CUtensorMap* map, const void* p, int qh, const Plan& g, int tw, int esize) {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
                cudaSuccess || found != cudaDriverEntryPointSuccess)
            fn = nullptr;
        return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {cuuint64_t(g.c), cuuint64_t(g.qw), cuuint64_t(qh)};
    const cuuint64_t strides[2] = {cuuint64_t(g.c) * esize, cuuint64_t(g.qw) * g.c * esize};
    const cuuint32_t box[3] = {cuuint32_t(kPixelBytes / esize), cuuint32_t(g.strip_w + tw - 1), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const auto type =
        esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    return encode(map, type, 3, const_cast<void*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

template <typename T>
int launch(const void* p, void* out, int qh, Plan g, const Taps& taps, cudaStream_t stream) {
    const auto kernel = kernel_for<T>(taps.th);
    const size_t smem = smem_for(g.strip_w, taps.tw, taps.th, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    g.vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 && (size_t(g.c) * sizeof(T)) % 16 == 0;
    g.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && g.c % 4 == 0;
    CUtensorMap map{};
    if (g.vec && !rows_map_for(&map, p, qh, g, taps.tw, int(sizeof(T))))
        return int(cudaErrorInvalidValue);
    constexpr int cb = kPixelBytes / int(sizeof(T));  // channels per block
    const long long blocks = (long long)((g.c + cb - 1) / cb) * g.bands * g.strips;
    if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    kernel<<<unsigned(blocks), g.threads, smem, stream>>>(static_cast<const T*>(p),
                                                         static_cast<float*>(out), g, taps, map);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for these shapes, dtype 0 = float32,
// 1 = bfloat16 (0 for shapes the launch refuses).
size_t sg3_fir_taps_smem_bytes(int qh, int qw, int c, int tw, int th, int dtype) {
    if (!valid(qh, qw, c, tw, th, dtype)) return 0;
    const int esize = dtype == 0 ? 4 : 2;
    return smem_for(make_plan(qh, qw, c, tw, th, esize).strip_w, tw, th, esize);
}

// Blocks of the launch for these shapes that the card keeps resident on one
// SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError_t; shapes the launch refuses give -cudaErrorInvalidValue.
int sg3_fir_taps_blocks_per_sm(int qh, int qw, int c, int tw, int th, int dtype) {
    if (!valid(qh, qw, c, tw, th, dtype)) return -int(cudaErrorInvalidValue);
    return dtype == 0 ? blocks_per_sm<float>(make_plan(qh, qw, c, tw, th, 4), tw, th)
                      : blocks_per_sm<__nv_bfloat16>(make_plan(qh, qw, c, tw, th, 2), tw, th);
}

// p: [qh, qw, c] device tensor, dtype 0 = float32, 1 = bfloat16. taps_w,
// taps_h: host float32 taps (tw <= qw and th <= qh, at most 64 each). out:
// float32 [qh - th + 1, qw - tw + 1, c] on the device. Returns the
// cudaError_t of the launch (0 on success).
int sg3_fir_taps(const void* p, const float* taps_w, const float* taps_h, void* out,
                 int dtype, int qh, int qw, int c, int tw, int th, void* stream) {
    if (!valid(qh, qw, c, tw, th, dtype)) return int(cudaErrorInvalidValue);
    Taps taps{};
    for (int k = 0; k < tw; ++k) taps.w[k] = taps_w[k];
    for (int k = 0; k < th; ++k) taps.h[k] = taps_h[k];
    taps.tw = tw;
    taps.th = th;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch<float>(p, out, qh, make_plan(qh, qw, c, tw, th, 4), taps, s)
                      : launch<__nv_bfloat16>(p, out, qh, make_plan(qh, qw, c, tw, th, 2), taps, s);
}

}  // extern "C"
