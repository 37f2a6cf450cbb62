// Flash attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (_flash_kernel).  Built by repro_torch/kernels/build.py with nvcc and bound
// through ctypes by repro_torch/kernels/flash_attention.py.
//
// What it computes: o = softmax(q k^T / sqrt(hd) + mask) v for q (B,Sq,H,hd)
// and k, v (B,Skv,KH,hd), GQA by reading KV head h / (H/KH).  fp32 inside,
// output in q's dtype; the online softmax carries (m, l, acc) over KV tiles
// with NEG_INF = -1e30, and the output is acc / max(l, 1e-30), as in the
// Pallas kernel.  The causal mask is its top-left rows >= cols.
//
// Design.  One thread block per (64-row q tile, batch*head).  The TPU kernel
// walks the KV tiles on a sequential third grid axis with (m, l, acc) in
// VMEM scratch; here the walk is a loop inside the block, and (m, l, acc)
// live in registers.  For a causal mask the loop stops at the diagonal tile,
// which replaces the pl.when skip of the tiles above it.  q, k and v are read
// in their (B,S,H,hd) layout through the strides given; no transpose and no
// repeat of the KV heads is made.  The ragged last tile of any length is
// masked (zero-filled loads, NEG_INF scores).
//
// Thread layout: 4 warps x 16 q rows.  Lane (rg = lane/8, cg = lane%8) owns
// 4 q rows and the score columns cg + 8j of a 64-column tile, then the
// output columns cg + 8jj.  The q, k and v tiles are staged in shared memory
// in fp32 (q and k rows padded by one word so column reads do not conflict);
// the P tile moves between lanes by warp shuffles.
//
// Bound: at the serving shape (glm4-9b, B=4, S=1024, bf16) the causal work
// is 2*B*H*S^2*hd = 34.4 GFLOP against ~71 MB of q, k, v and o, so the
// kernel is bound by operations.  This first version multiplies on the fp32
// CUDA cores (exact in fp32, so it holds the reference's fp32 tolerance); it
// does not reach the tensor-core bound.  wgmma, TMA and warp specialisation
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 128;  // 4 warps x 16 q rows
constexpr int RPT = 4;        // q rows per thread
constexpr int CPT = BN / 8;   // score columns per thread
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float group_max(float x) {  // over the 8 lanes of a row group
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
    return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    return x + __shfl_xor_sync(FULL, x, 4);
}

template <int HD>
constexpr size_t smem_bytes() {
    return (size_t)(BM * (HD + 1) + BN * (HD + 1) + BN * HD) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Skv, int H, int group,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 float scale, int causal) {
    constexpr int LD = HD + 1;
    constexpr int DPT = HD / 8;  // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;            // [BM][LD]
    float* Ks = Qs + BM * LD;    // [BN][LD]
    float* Vs = Ks + BN * LD;    // [BN][HD]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int rg = lane / 8, cg = lane % 8;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest causal rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;

    const T* qp = q + b * qsb + h * qsh;
    const T* kp = k + b * ksb + (h / group) * ksh;
    const T* vp = v + b * vsb + (h / group) * vsh;

    for (int i = tid; i < BM * HD; i += THREADS) {
        const int r = i / HD, d = i % HD, row = q0 + r;
        Qs[r * LD + d] = row < Sq ? to_f32(qp[row * qss + d]) : 0.f;
    }

    const int r0 = warp * 16 + rg * RPT;  // this thread's first q row in the tile
    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
    }

    int n_tiles = (Skv + BN - 1) / BN;
    if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // stop at the diagonal

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BN;
        __syncthreads();  // the previous tile is consumed (and Qs is complete)
        for (int i = tid; i < BN * HD; i += THREADS) {
            const int r = i / HD, d = i % HD, row = k0 + r;
            const bool ok = row < Skv;
            Ks[r * LD + d] = ok ? to_f32(kp[row * kss + d]) : 0.f;
            Vs[r * HD + d] = ok ? to_f32(vp[row * vss + d]) : 0.f;
        }
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float qv[RPT], kv[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) qv[i] = Qs[(r0 + i) * LD + d];
#pragma unroll
            for (int j = 0; j < CPT; ++j) kv[j] = Ks[(cg + 8 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int row = q0 + r0 + i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int col = k0 + cg + 8 * j;
                const bool valid = col < Skv && (!causal || row >= col);
                s[i][j] = valid ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], group_max(mx));
            const float corr = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
            l[i] = l[i] * corr + group_sum(sum);
            m[i] = m_new;
#pragma unroll
            for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= corr;
        }

        // acc += P V.  Column c = src + 8j of P is held by lane rg*8 + src.
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
#pragma unroll
            for (int src = 0; src < 8; ++src) {
                const int c = src + 8 * j;
                float p[RPT];
#pragma unroll
                for (int i = 0; i < RPT; ++i) p[i] = __shfl_sync(FULL, s[i][j], rg * 8 + src);
#pragma unroll
                for (int jj = 0; jj < DPT; ++jj) {
                    const float vv = Vs[c * HD + cg + 8 * jj];
#pragma unroll
                    for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + r0 + i;
        if (row < Sq) {
            const float denom = fmaxf(l[i], 1e-30f);
            T* op = o + ((int64_t)(b * Sq + row) * H + h) * HD;
#pragma unroll
            for (int jj = 0; jj < DPT; ++jj) op[cg + 8 * jj] = from_f32<T>(acc[i][jj] / denom);
        }
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KH,
                   int64_t qsb, int64_t qss, int64_t qsh,
                   int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh,
                   int causal, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BM - 1) / BM, B * H);
    flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Skv, H, H / KH,
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KH,
                        int64_t qsb, int64_t qss, int64_t qsh,
                        int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh,
                        int causal, float scale, cudaStream_t stream) {
#define REPRO_FLASH_HD(N)                                                           \
    case N:                                                                         \
        return launch<T, N>(q, k, v, o, B, Sq, Skv, H, KH, qsb, qss, qsh, ksb, kss, \
                            ksh, vsb, vss, vsh, causal, scale, stream);
    switch (hd) {
        REPRO_FLASH_HD(16)
        REPRO_FLASH_HD(32)
        REPRO_FLASH_HD(64)
        REPRO_FLASH_HD(128)
        default:
            return cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_HD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// is contiguous and o is a contiguous (B, Sq, H, hd) tensor.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Skv, int H, int KH, int hd,
                                   int64_t qsb, int64_t qss, int64_t qsh,
                                   int64_t ksb, int64_t kss, int64_t ksh,
                                   int64_t vsb, int64_t vss, int64_t vsh,
                                   int causal, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KH, qsb, qss, qsh, ksb, kss,
                                  ksh, vsb, vss, vsh, causal, scale, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KH, qsb, qss, qsh,
                                          ksb, kss, ksh, vsb, vss, vsh, causal, scale, st);
    return cudaErrorInvalidValue;
}
