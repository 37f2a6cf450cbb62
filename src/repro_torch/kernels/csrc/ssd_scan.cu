// Mamba2 SSD chunk scan forward for Hopper (sm_90a): the CUDA counterpart
// of the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_fwd
// (_ssd_kernel).  Built by repro_torch/kernels/build.py with nvcc and bound
// through ctypes by repro_torch/kernels/ssd_scan.py.
//
// What it computes, for each (batch b, head h), with h_{-1} = 0:
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t x_t^T ;   y_t = C_t . h_t
// for x (B,S,H,P), dt (B,S,H) fp32, A = a_neg (H,) fp32 and B, C (B,S,N)
// shared by the heads.  It runs in chunks of L steps as the TPU kernel does:
//   y_intra = (C B^T o exp(segsum) o dt) x   (segsum masked causal BEFORE exp)
//   y_inter = (C h^T) * exp(cumsum)          (h from before the update)
//   h       = h exp(a_L) + x^T (B dt exp(a_L - cumsum))
// fp32 inside, y in x's dtype.  Unlike the TPU kernel it also writes the
// final state h_final (B,H,P,N) fp32, which the model's prefill keeps for
// decode, and it takes any S: the ragged last chunk is masked as dt = 0
// steps (decay 1, no input), which is exact, and its masked rows write no y.
//
// Design.  One thread block per (b, h): the TPU's sequential grid axis over
// chunks, with h in VMEM scratch, becomes a loop inside the block with the
// (P, N) fp32 state in shared memory.  A chunk is staged in shared memory in
// fp32 (x as L x P, B and C as L x N, dt), the cumulative sum of dt A is a
// warp scan, and the four products of a chunk step run on the fp32 CUDA
// cores from shared memory, each thread owning a 16-strided tile of the
// output: rows ty + 16 i, columns tx + 16 j of a 16 x 16 thread grid.  C
// B^T is formed in registers and, once every read of C is done, written
// over C as the masked, decayed weight matrix W, so the largest chunk
// (L = 128, N = 128, P = 64) fits in 199 KB.  Rows of B, C and h are padded
// by one word so column walks do not conflict in the banks.  The chunk tile
// L is 16, 32, 64 or 128 (a template argument); a chunk shorter than its
// tile (chunk = min(64, S) for a short prompt) masks the rest.
//
// Bound: at the serving shape (mamba2-370m, B=8, S=2048, H=32, P=64,
// N=128, L=64, bf16) the scan moves ~153 MB (x and y dominate) and does
// ~22 GFLOP, so it is bound by bytes (~46 us at 3.35 TB/s).  This first
// version multiplies in fp32 on the CUDA cores (for both dtypes: TF32
// would not hold the reference's 1e-4 pin), recomputes C B^T for every
// head, and runs 256 blocks of one per SM, so it sits far above that bound;
// the tensor cores (mma.sync / wgmma on bf16 tiles), C B^T once per (b,
// chunk) and more blocks in flight are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int MAXJ = 8;       // N <= 16 * MAXJ
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype does
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Floats of shared memory for a chunk tile of LT rows (see the layout below).
__host__ __device__ constexpr int smem_floats(int LT, int P, int N) {
    return LT * P + LT * (N + 1) + LT * imax(N + 1, LT + 1) + P * (N + 1) + 2 * LT;
}

template <typename T, int LT, int PJ>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_neg, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_out,
                int S, int H, int P, int N, int chunk,
                int64_t xsb, int64_t xss, int64_t xsh,
                int64_t dsb, int64_t dss, int64_t dsh,
                int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
    constexpr int LI = LT / 16;  // chunk rows per thread (PJ = P / 16 columns)
    const int NJ = N / 16;
    const int NP = N + 1;        // padded rows of B, C and h
    constexpr int WLD = LT + 1;  // padded rows of W
    extern __shared__ float smem[];
    float* xs = smem;                      // [LT][P]   x of the chunk
    float* bs = xs + LT * P;               // [LT][NP]  B, then B * dt * exp(a_L - cumsum)
    float* cw = bs + LT * NP;              // [LT][NP]  C, then [LT][WLD] W
    float* hs = cw + LT * imax(NP, WLD);   // [P][NP]   the state
    float* dts = hs + P * NP;              // [LT]      dt (0 on masked rows)
    float* acum = dts + LT;                // [LT]      inclusive cumsum of dt A

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const float a = a_neg[h];
    const T* xp = x + b * xsb + h * xsh;
    const float* dp = dt + b * dsb + h * dsh;
    const T* bp = Bm + b * bsb;
    const T* cp = Cm + b * csb;
    T* yp = y + ((int64_t)b * S * H + h) * P;  // step t at yp + t * H * P
    const int64_t ys = (int64_t)H * P;

    for (int i = tid; i < P * NP; i += THREADS) hs[i] = 0.f;

    const int n_chunks = (S + chunk - 1) / chunk;
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * chunk;
        const int valid = min(chunk, S - t0);
        __syncthreads();  // the previous chunk is consumed (and hs is zeroed)
        for (int i = tid; i < LT * P; i += THREADS) {
            const int l = i / P, p = i % P;
            xs[i] = l < valid ? to_f32(xp[(t0 + l) * xss + p]) : 0.f;
        }
        for (int i = tid; i < LT * N; i += THREADS) {
            const int l = i / N, n = i % N;
            const bool ok = l < valid;
            bs[l * NP + n] = ok ? to_f32(bp[(t0 + l) * bss + n]) : 0.f;
            cw[l * NP + n] = ok ? to_f32(cp[(t0 + l) * css + n]) : 0.f;
        }
        for (int l = tid; l < LT; l += THREADS) dts[l] = l < valid ? dp[(t0 + l) * dss] : 0.f;
        __syncthreads();

        // Inclusive cumsum of dt A by warp 0: each lane sums PER consecutive
        // steps, then the lanes' totals are scanned by shuffles.
        if (tid < 32) {
            constexpr int PER = (LT + 31) / 32;
            float v[PER];
            float run = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int l = tid * PER + k;
                run += l < LT ? dts[l] * a : 0.f;
                v[k] = run;
            }
            float tot = run;
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const float o = __shfl_up_sync(FULL, tot, off);
                if (tid >= off) tot += o;
            }
            float before = __shfl_up_sync(FULL, tot, 1);  // the lanes below
            if (tid == 0) before = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int l = tid * PER + k;
                if (l < LT) acum[l] = before + v[k];
            }
        }
        __syncthreads();

        // y_inter = (C h^T) * exp(cumsum): rows l = ty + 16 i, columns p = tx + 16 j.
        float yacc[LI][PJ];
#pragma unroll
        for (int i = 0; i < LI; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) yacc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
            float cv[LI], hv[PJ];
#pragma unroll
            for (int i = 0; i < LI; ++i) cv[i] = cw[(ty + 16 * i) * NP + n];
#pragma unroll
            for (int j = 0; j < PJ; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
            for (int i = 0; i < LI; ++i)
#pragma unroll
                for (int j = 0; j < PJ; ++j) yacc[i][j] = fmaf(cv[i], hv[j], yacc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < LI; ++i) {
            const float e = expf(acum[ty + 16 * i]);
#pragma unroll
            for (int j = 0; j < PJ; ++j) yacc[i][j] *= e;
        }

        // C B^T: rows l = ty + 16 i, columns m = tx + 16 j.
        float wacc[LI][LI];
#pragma unroll
        for (int i = 0; i < LI; ++i)
#pragma unroll
            for (int j = 0; j < LI; ++j) wacc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
            float cv[LI], bv[LI];
#pragma unroll
            for (int i = 0; i < LI; ++i) {
                cv[i] = cw[(ty + 16 * i) * NP + n];
                bv[i] = bs[(tx + 16 * i) * NP + n];
            }
#pragma unroll
            for (int i = 0; i < LI; ++i)
#pragma unroll
                for (int j = 0; j < LI; ++j) wacc[i][j] = fmaf(cv[i], bv[j], wacc[i][j]);
        }
        __syncthreads();  // every read of C and B is done: W goes over C, B is scaled

        const float a_end = acum[LT - 1];  // masked steps add 0: the chunk's total
#pragma unroll
        for (int i = 0; i < LI; ++i) {
            const int l = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < LI; ++j) {
                const int m = tx + 16 * j;
                cw[l * WLD + m] = m <= l ? wacc[i][j] * expf(acum[l] - acum[m]) * dts[m] : 0.f;
            }
        }
        for (int i = tid; i < LT * N; i += THREADS) {
            const int l = i / N, n = i % N;
            bs[l * NP + n] *= dts[l] * expf(a_end - acum[l]);
        }
        __syncthreads();

        // y = y_inter + W x, written for the valid rows.
        for (int m = 0; m < LT; ++m) {
            float wv[LI], xv[PJ];
#pragma unroll
            for (int i = 0; i < LI; ++i) wv[i] = cw[(ty + 16 * i) * WLD + m];
#pragma unroll
            for (int j = 0; j < PJ; ++j) xv[j] = xs[m * P + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < LI; ++i)
#pragma unroll
                for (int j = 0; j < PJ; ++j) yacc[i][j] = fmaf(wv[i], xv[j], yacc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < LI; ++i) {
            const int l = ty + 16 * i;
            if (l < valid) {
#pragma unroll
                for (int j = 0; j < PJ; ++j) yp[(t0 + l) * ys + tx + 16 * j] = from_f32<T>(yacc[i][j]);
            }
        }

        // h = h exp(a_L) + x^T (B dt exp(a_L - cumsum)): this thread's entries
        // are p = tx + 16 j, n = ty + 16 i; no other thread reads them here.
        float hacc[MAXJ][PJ];
#pragma unroll
        for (int i = 0; i < MAXJ; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) hacc[i][j] = 0.f;
        for (int l = 0; l < LT; ++l) {
            float xv[PJ];
#pragma unroll
            for (int j = 0; j < PJ; ++j) xv[j] = xs[l * P + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < MAXJ; ++i) {
                if (i < NJ) {
                    const float bv = bs[l * NP + ty + 16 * i];
#pragma unroll
                    for (int j = 0; j < PJ; ++j) hacc[i][j] = fmaf(xv[j], bv, hacc[i][j]);
                }
            }
        }
        const float e_end = expf(a_end);
#pragma unroll
        for (int i = 0; i < MAXJ; ++i) {
            if (i < NJ) {
#pragma unroll
                for (int j = 0; j < PJ; ++j) {
                    float* hp = hs + (tx + 16 * j) * NP + ty + 16 * i;
                    *hp = *hp * e_end + hacc[i][j];
                }
            }
        }
    }
    __syncthreads();
    float* ho = h_out + (int64_t)blockIdx.x * P * N;
    for (int i = tid; i < P * N; i += THREADS) ho[i] = hs[(i / N) * NP + i % N];
}

template <typename T, int LT, int PJ>
cudaError_t launch(const void* x, const void* dt, const void* a_neg, const void* Bm,
                   const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
                   int N, int chunk, const int64_t* st, cudaStream_t stream) {
    const size_t smem = (size_t)smem_floats(LT, P, N) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, LT, PJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<T, LT, PJ><<<B * H, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_neg), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<float*>(h_out),
        S, H, P, N, chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9]);
    return cudaGetLastError();
}

template <typename T, int LT>
cudaError_t dispatch_p(const void* x, const void* dt, const void* a_neg, const void* Bm,
                       const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
                       int N, int chunk, const int64_t* st, cudaStream_t stream) {
    switch (P) {
        case 16: return launch<T, LT, 1>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        case 32: return launch<T, LT, 2>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        case 64: return launch<T, LT, 4>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t dispatch_tile(int tile, const void* x, const void* dt, const void* a_neg,
                          const void* Bm, const void* Cm, void* y, void* h_out, int B,
                          int S, int H, int P, int N, int chunk, const int64_t* st,
                          cudaStream_t stream) {
    switch (tile) {
        case 16: return dispatch_p<T, 16>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        case 32: return dispatch_p<T, 32>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        case 64: return dispatch_p<T, 64>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        case 128: return dispatch_p<T, 128>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and a_neg are
// float32.  P is 16, 32 or 64; N a multiple of 16 up to 128; tile the chunk
// tile (16, 32, 64 or 128, at least chunk).  strides holds, in elements, x's
// (batch, step, head), dt's (batch, step, head), B's (batch, step) and C's
// (batch, step); the last dims of x, B and C are contiguous, y is a
// contiguous (B, S, H, P) tensor and h_out a contiguous (B, H, P, N) one.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                            const void* Cm, void* y, void* h_out, int dtype, int B, int S,
                            int H, int P, int N, int chunk, int tile, const int64_t* strides,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N % 16 || N < 16 || N > 16 * MAXJ || chunk < 1 || chunk > tile || S < 1)
        return cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch_tile<float>(tile, x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N,
                                    chunk, strides, st);
    if (dtype == 1)
        return dispatch_tile<__nv_bfloat16>(tile, x, dt, a_neg, Bm, Cm, y, h_out, B, S, H,
                                            P, N, chunk, strides, st);
    return cudaErrorInvalidValue;
}
