// Mamba2 SSD chunk scan forward for Hopper (sm_90a), fp32, on the TF32
// tensor cores by split products (3xTF32): the fp32 route of the CUDA
// counterpart of the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_scan_fwd (_ssd_kernel).  bf16 inputs take ssd_scan_tc.cu; the wrapper
// (repro_torch/kernels/ssd_scan.py) dispatches by dtype.  Built by
// repro_torch/kernels/build.py with nvcc.
//
// What it computes, for each (batch b, head h), with h_{-1} = 0:
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t x_t^T ;   y_t = C_t . h_t
// for fp32 x (B,S,H,P), dt (B,S,H), A = a_neg (H,) and B, C (B,S,N) shared
// by the heads.  It runs in chunks of L steps as the TPU kernel does:
//   W       = mask(C B^T o exp(segsum) o dt)   (masked causal BEFORE exp)
//   y       = W x + (C h^T) * exp(cumsum)      (h from before the update)
//   h       = h exp(a_L) + x^T (B dt exp(a_L - cumsum))
// y in fp32.  Unlike the TPU kernel it also writes the final state h_final
// (B,H,P,N) fp32, which the model's prefill keeps for decode, and it takes
// any S: the ragged last chunk is masked as dt = 0 steps (decay 1, no
// input), which is exact, and its masked rows write no y.
//
// Precision.  One TF32 pass misses the fp32 pin (1e-4) on y by far.  Every
// product runs as three mma.sync m16n8k8 TF32 passes on operands split into
// hi + lo (hopper.cuh split_tf32, mma_3xtf32), summed in fp32; what is
// dropped is about 2^-22 of each term.  Each operand is split as it enters
// its fragment: C, B, x, the fp32 W and state copy in shared memory, and
// the scaled B (B dt exp(a_L - cumsum)) formed in registers.
// tests/test_torch_tc_precision.py emulates these roundings against the
// reference at the pins.
//
// Bound: at the serving shape (B=8, S=2048, H=32, P=64, N=128, L=64) the
// scan does 21.7 GFLOP (C B^T counted once per (batch, chunk)) on ~296 MB:
// three TF32 passes take 0.132 ms and the bytes 0.088 ms.
//
// Design.  One block of 8 warps per (b, h) walks the chunks in order, since
// the state carries across them; the structure is ssd_scan_tc.cu's.
// - The state h^T (N x P, fp32) lives in the state product's accumulator
//   fragments across all chunks: warp w owns rows n in [16w, 16w + 16).
//   Each chunk it is scaled by exp(a_L), the new product is accumulated into
//   it, and an fp32 copy is written to shared memory for the next C h^T.
// - The chunk tiles stay fp32 in shared memory: x (L x P), B and C (L x N)
//   and dt, fetched by cp.async into a 2-stage ring (16-byte pieces where
//   every base and stride allows it, else 4-byte ones), so chunk c+1 loads
//   while chunk c computes; one stage at L = 128, where two do not fit.  At
//   L = 64, P = 64, N = 128 the block takes 212 KB: one block a SM.
// - A chunk step, between three block barriers:
//   1. warp 0 scans dt A (cumsum) and forms the state weights
//      f_l = dt_l exp(a_L - cumsum_l); every warp forms its share of the
//      causal 16 x 16 blocks of G = C B^T and its y tile's C h^T;
//   2. the warps write W = mask(G exp(segsum) dt) in fp32 over C, which no
//      one reads any more;
//   3. y = (C h^T) exp(cumsum) + W x is written for the valid rows, and the
//      state update runs with A = (B f)^T read from B and scaled by f.
// - Fragments are read from padded fp32 rows (ldmatrix and its transpose
//   move 16-bit elements).  C h^T and C B^T take the k index by pairs (k t
//   is column 2t, k t+4 column 2t+1), so C and B are read 8 bytes at a time;
//   the pads make each warp's reads cover the 32 banks once.
// - More blocks in flight: the P columns of one (b, h) could be split over
//   blocks (a state row depends only on its x column).  Split in two
//   32-column blocks of one stage, 99 KB each, two blocks fit a SM, but
//   on the H100 that ran slower at the serving shape than this layout:
//   each part pays the chunk's G, W and cumsum again, which outweighs the
//   doubled warps.  So P stays whole.
//   G is recomputed for every head, as in ssd_scan_tc.cu: sharing it would
//   take a second pass through device memory (4.2 MB at the serving shape).
// The chunk tile L is 16, 32, 64 or 128 and P 16, 32 or 64 (template
// arguments); N is a multiple of 16 up to 128.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int MAX_N = 16 * WARPS;  // a 16-row strip of the state per warp
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory in floats: STAGES x {x [LT][LDX], B [LT][LDB], C (then W
// [LT][LDW]) [LT][LDB], dt [LT]}, then the state copy h^T [N][LDH], the
// cumsum and the state weights.  Row pads (mod 32 words): LDX, LDB = 8 (the
// column reads x[t][8j + g] and B[t][16w + g] and the 8-byte row reads
// C[g][2t] cover the banks), LDW = 4 (W[g][t]), LDH = 4 mod 16 (h^T[2t][g]).
template <int LT, int P>
struct Layout {
    static constexpr int STAGES = LT == 128 ? 1 : 2;
    static constexpr int LDX = P + (40 - P % 32) % 32;
    static constexpr int LDW = LT + (36 - LT % 32) % 32;
    static constexpr int LDH = P + 4;
    static constexpr int NS = LT / 16;                        // 16-row strips
    static constexpr int NG = WARPS / NS;                     // warps per strip
    static constexpr int PT = P / 8;                          // n8 tiles over P
    static constexpr int YT = (PT + NG - 1) / NG;             // y tiles a warp owns
    static constexpr int NBLK = NS * (NS + 1) / 2;            // causal G blocks
    static constexpr int GB = (NBLK + WARPS - 1) / WARPS;     // G blocks a warp owns
    __host__ __device__ static int ldb(int N) { return N + (40 - N % 32) % 32; }
    __host__ __device__ static int b_off() { return LT * LDX; }
    __host__ __device__ static int cw_off(int N) { return b_off() + LT * ldb(N); }
    __host__ __device__ static int dt_off(int N) { return cw_off(N) + cmax(LT * ldb(N), LT * LDW); }
    __host__ __device__ static int stage_floats(int N) { return dt_off(N) + LT; }
    __host__ __device__ static int hs_off(int N) { return STAGES * stage_floats(N); }
    __host__ __device__ static int acum_off(int N) { return hs_off(N) + N * LDH; }
    __host__ __device__ static int f_off(int N) { return acum_off(N) + LT; }
    __host__ __device__ static int smem_bytes(int N) { return (f_off(N) + LT) * 4; }
};

template <int LT, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_neg, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, float* __restrict__ y,
                  float* __restrict__ h_out, int S, int H, int N, int chunk, int vec,
                  int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss, int64_t dsh,
                  int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
    using Ly = Layout<LT, P>;
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row, column
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const float a = a_neg[h];
    const int LDB = Ly::ldb(N);
    const float* xp = x + b * xsb + h * xsh;
    const float* dp = dt + b * dsb + h * dsh;
    const float* bp = Bm + b * bsb;
    const float* cp = Cm + b * csb;
    float* yp = y + ((int64_t)b * S * H + h) * P;  // step t at yp + t * H * P
    const int64_t ys = (int64_t)H * P;
    float* hs = smem + Ly::hs_off(N);
    float* acum = smem + Ly::acum_off(N);
    float* fsc = smem + Ly::f_off(N);

    // rows [t0, t0 + LT) of an (S, w) matrix (row stride ss) into dst (row
    // stride ld), zeros from row valid on.
    auto load_rows = [&](float* dst, int ld, const float* src, int64_t ss, int t0, int valid,
                         int w) {
        const uint32_t d0 = smem_u32(dst);
        if (vec) {
            for (int i = tid; i < LT * (w / 4); i += THREADS) {
                const int l = i / (w / 4), c = 4 * (i % (w / 4));
                const bool ok = l < valid;
                cp_async_16(d0 + (l * ld + c) * 4, ok ? src + (t0 + l) * ss + c : src, ok);
            }
        } else {
            for (int i = tid; i < LT * w; i += THREADS) {
                const int l = i / w, c = i % w;
                const bool ok = l < valid;
                cp_async_4(d0 + (l * ld + c) * 4, ok ? src + (t0 + l) * ss + c : src, ok);
            }
        }
    };
    auto stage = [&](int c) { return smem + (c % Ly::STAGES) * Ly::stage_floats(N); };
    auto issue = [&](int c) {  // cp.async of chunk c into its stage, zero past S
        float* s0 = stage(c);
        const int t0 = c * chunk, valid = min(chunk, S - t0);
        load_rows(s0, Ly::LDX, xp, xss, t0, valid, P);
        load_rows(s0 + Ly::b_off(), LDB, bp, bss, t0, valid, N);
        load_rows(s0 + Ly::cw_off(N), LDB, cp, css, t0, valid, N);
        const uint32_t d0 = smem_u32(s0 + Ly::dt_off(N));
        for (int l = tid; l < LT; l += THREADS) {
            const bool ok = l < valid;
            cp_async_4(d0 + l * 4, ok ? dp + (t0 + l) * dss : dp, ok);
        }
        cp_async_commit();
    };

    for (int i = tid; i < N * Ly::LDH; i += THREADS) hs[i] = 0.f;
    float hacc[Ly::PT][4];  // h^T rows n = 16 warp + g (+8), columns p = 8j + 2t (+1)
#pragma unroll
    for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) hacc[j][r] = 0.f;

    const int strip = warp % Ly::NS, grp = warp / Ly::NS;  // this warp's y tiles
    const int n_chunks = (S + chunk - 1) / chunk;
    if (Ly::STAGES == 2) issue(0);
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * chunk, valid = min(chunk, S - t0);
        if (Ly::STAGES == 1) {
            __syncthreads();  // the previous chunk is consumed
            issue(c);
        }
        cp_async_wait<0>();
        __syncthreads();  // chunk c has landed; the previous chunk is consumed
        if (Ly::STAGES == 2 && c + 1 < n_chunks) issue(c + 1);
        const float* xs = stage(c);
        const float* bs = xs + Ly::b_off();
        float* cw = stage(c) + Ly::cw_off(N);
        const float* dts = xs + Ly::dt_off(N);

        // ---- 1. cumsum and state weights (warp 0); G blocks; C h^T ----
        if (warp == 0) {
            // Each lane sums PER consecutive steps, then the lanes' totals are
            // scanned by shuffles (as ssd_scan_tc.cu does).
            constexpr int PER = (LT + 31) / 32;
            float v[PER];
            float run = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int l = lane * PER + k;
                run += l < LT ? dts[l] * a : 0.f;
                v[k] = run;
            }
            float tot = run;
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const float o = __shfl_up_sync(FULL, tot, off);
                if (lane >= off) tot += o;
            }
            float before = __shfl_up_sync(FULL, tot, 1);
            if (lane == 0) before = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int l = lane * PER + k;
                if (l < LT) acum[l] = before + v[k];
            }
            __syncwarp();
            const float a_end = acum[LT - 1];  // masked steps add 0: the chunk's total
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int l = lane * PER + k;
                if (l < LT) fsc[l] = dts[l] * expf(a_end - acum[l]);
            }
        }

        // C's A fragment of rows r, r + 8 at k step kk: k t <-> column 8kk + 2t,
        // k t+4 <-> 8kk + 2t + 1.
        auto c_frag = [&](int r, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            const float2 u = *reinterpret_cast<const float2*>(cw + (r + g) * LDB + 8 * kk + 2 * t);
            const float2 w = *reinterpret_cast<const float2*>(cw + (r + g + 8) * LDB + 8 * kk + 2 * t);
            split_tf32(u.x, hi[0], lo[0]);
            split_tf32(w.x, hi[1], lo[1]);
            split_tf32(u.y, hi[2], lo[2]);
            split_tf32(w.y, hi[3], lo[3]);
        };

        float gacc[Ly::GB][2][4];
#pragma unroll
        for (int u = 0; u < Ly::GB; ++u) {
#pragma unroll
            for (int tt = 0; tt < 2; ++tt)
#pragma unroll
                for (int r = 0; r < 4; ++r) gacc[u][tt][r] = 0.f;
            const int bi = warp + WARPS * u;
            if (bi < Ly::NBLK) {
                int lb = 0;
                while ((lb + 1) * (lb + 2) / 2 <= bi) ++lb;
                const int mb = bi - lb * (lb + 1) / 2;
#pragma unroll 4
                for (int kk = 0; kk < N / 8; ++kk) {
                    uint32_t ah[4], al[4];
                    c_frag(lb * 16, kk, ah, al);
#pragma unroll
                    for (int tt = 0; tt < 2; ++tt) {
                        const float2 bv = *reinterpret_cast<const float2*>(
                            bs + (mb * 16 + 8 * tt + g) * LDB + 8 * kk + 2 * t);
                        uint32_t bh[2], bl[2];
                        split_tf32(bv.x, bh[0], bl[0]);
                        split_tf32(bv.y, bh[1], bl[1]);
                        mma_3xtf32(gacc[u][tt], ah, al, bh, bl);
                    }
                }
            }
        }

        float yacc[Ly::YT][4];  // y rows 16 strip + g (+8), columns p = 8j + 2t (+1)
#pragma unroll
        for (int jt = 0; jt < Ly::YT; ++jt)
#pragma unroll
            for (int r = 0; r < 4; ++r) yacc[jt][r] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < N / 8; ++kk) {
            uint32_t ah[4], al[4];
            c_frag(strip * 16, kk, ah, al);
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                const int j = grp * Ly::YT + jt;
                if (j < Ly::PT) {
                    const float* hv = hs + (8 * kk + 2 * t) * Ly::LDH + 8 * j + g;
                    uint32_t bh[2], bl[2];
                    split_tf32(hv[0], bh[0], bl[0]);
                    split_tf32(hv[Ly::LDH], bh[1], bl[1]);
                    mma_3xtf32(yacc[jt], ah, al, bh, bl);
                }
            }
        }
        __syncthreads();  // C is read; the cumsum and weights are written

        // ---- 2. W = mask(G exp(segsum) dt) in fp32 over C ----
#pragma unroll
        for (int u = 0; u < Ly::GB; ++u) {
            const int bi = warp + WARPS * u;
            if (bi < Ly::NBLK) {
                int lb = 0;
                while ((lb + 1) * (lb + 2) / 2 <= bi) ++lb;
                const int mb = bi - lb * (lb + 1) / 2;
#pragma unroll
                for (int tt = 0; tt < 2; ++tt)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int l = lb * 16 + g + 8 * i, m = mb * 16 + 8 * tt + 2 * t;
                        const float w0 = m <= l ? gacc[u][tt][2 * i] * expf(acum[l] - acum[m]) *
                                                      dts[m]
                                                : 0.f;
                        const float w1 = m + 1 <= l ? gacc[u][tt][2 * i + 1] *
                                                          expf(acum[l] - acum[m + 1]) * dts[m + 1]
                                                    : 0.f;
                        *reinterpret_cast<float2*>(cw + l * Ly::LDW + m) = make_float2(w0, w1);
                    }
            }
        }
        __syncthreads();  // W is written

        // ---- 3. y = (C h^T) exp(cumsum) + W x; the state update ----
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float e = expf(acum[strip * 16 + g + 8 * i]);
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                yacc[jt][2 * i] *= e;
                yacc[jt][2 * i + 1] *= e;
            }
        }
#pragma unroll 2
        for (int kk = 0; kk < 2 * (strip + 1); ++kk) {  // W is zero above the diagonal
            const float* wr = cw + (strip * 16 + g) * Ly::LDW + 8 * kk + t;
            uint32_t ah[4], al[4];
            split_tf32(wr[0], ah[0], al[0]);
            split_tf32(wr[8 * Ly::LDW], ah[1], al[1]);
            split_tf32(wr[4], ah[2], al[2]);
            split_tf32(wr[8 * Ly::LDW + 4], ah[3], al[3]);
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                const int j = grp * Ly::YT + jt;
                if (j < Ly::PT) {
                    const float* xv = xs + (8 * kk + t) * Ly::LDX + 8 * j + g;
                    uint32_t bh[2], bl[2];
                    split_tf32(xv[0], bh[0], bl[0]);
                    split_tf32(xv[4 * Ly::LDX], bh[1], bl[1]);
                    mma_3xtf32(yacc[jt], ah, al, bh, bl);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int l = strip * 16 + g + 8 * i;
            if (l < valid) {
#pragma unroll
                for (int jt = 0; jt < Ly::YT; ++jt) {
                    const int j = grp * Ly::YT + jt;
                    if (j < Ly::PT)
                        *reinterpret_cast<float2*>(yp + (t0 + l) * ys + 8 * j + 2 * t) =
                            make_float2(yacc[jt][2 * i], yacc[jt][2 * i + 1]);
                }
            }
        }

        if (warp < N / 16) {
            const float e_end = expf(acum[LT - 1]);
#pragma unroll
            for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) hacc[j][r] *= e_end;
#pragma unroll
            for (int kk = 0; kk < LT / 8; ++kk) {
                // A = (B f)^T: rows n = 16 warp + g (+8), k t <-> step 8kk + t (+4).
                const float* br = bs + (8 * kk + t) * LDB + 16 * warp + g;
                const float f0 = fsc[8 * kk + t], f4 = fsc[8 * kk + t + 4];
                uint32_t ah[4], al[4];
                split_tf32(br[0] * f0, ah[0], al[0]);
                split_tf32(br[8] * f0, ah[1], al[1]);
                split_tf32(br[4 * LDB] * f4, ah[2], al[2]);
                split_tf32(br[4 * LDB + 8] * f4, ah[3], al[3]);
#pragma unroll
                for (int j = 0; j < Ly::PT; ++j) {
                    const float* xv = xs + (8 * kk + t) * Ly::LDX + 8 * j + g;
                    uint32_t bh[2], bl[2];
                    split_tf32(xv[0], bh[0], bl[0]);
                    split_tf32(xv[4 * Ly::LDX], bh[1], bl[1]);
                    mma_3xtf32(hacc[j], ah, al, bh, bl);
                }
            }
            // the copy the next chunk's C h^T reads: h^T [n][p]
#pragma unroll
            for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    *reinterpret_cast<float2*>(hs + (warp * 16 + g + 8 * i) * Ly::LDH + 8 * j +
                                               2 * t) =
                        make_float2(hacc[j][2 * i], hacc[j][2 * i + 1]);
        }
    }

    if (warp < N / 16) {
        float* ho = h_out + (int64_t)blockIdx.x * P * N;
#pragma unroll
        for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
                    ho[(j * 8 + 2 * t + jj) * N + warp * 16 + g + 8 * i] = hacc[j][2 * i + jj];
    }
}

template <int LT, int P>
int launch(const void* x, const void* dt, const void* a_neg, const void* Bm, const void* Cm,
           void* y, void* h_out, int B, int S, int H, int N, int chunk, int vec,
           const int64_t* st, cudaStream_t stream) {
    const int smem = Layout<LT, P>::smem_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(ssd_tf32x3_kernel<LT, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ssd_tf32x3_kernel<LT, P><<<B * H, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_neg), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(h_out), S, H,
        N, chunk, vec, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
    return cudaGetLastError();
}

template <int LT>
int dispatch_p(const void* x, const void* dt, const void* a_neg, const void* Bm, const void* Cm,
               void* y, void* h_out, int B, int S, int H, int P, int N, int chunk, int vec,
               const int64_t* st, cudaStream_t stream) {
    switch (P) {
        case 16: return launch<LT, 16>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, vec, st, stream);
        case 32: return launch<LT, 32>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, vec, st, stream);
        case 64: return launch<LT, 64>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, vec, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// fp32 x, dt, a_neg, Bm, Cm, y and h_out.  P is 16, 32 or 64; N a multiple
// of 16 up to 128; tile the chunk tile (16, 32, 64 or 128, at least chunk).
// strides holds, in elements, x's (batch, step, head), dt's (batch, step,
// head), B's (batch, step) and C's (batch, step); the last dims of x, B and C
// are contiguous, y is a contiguous (B, S, H, P) tensor and h_out a
// contiguous (B, H, P, N) one.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                            const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
                            int N, int chunk, int tile, const int64_t* strides, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N % 16 || N < 16 || N > MAX_N || chunk < 1 || chunk > tile || S < 1)
        return cudaErrorInvalidValue;
    // 16-byte copies of x, B and C need aligned bases and strides of whole
    // 4-float units
    const int64_t* s = strides;
    const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                      reinterpret_cast<uintptr_t>(Cm)) % 16 == 0) &&
                    ((s[0] | s[1] | s[2] | s[6] | s[7] | s[8] | s[9]) % 4 == 0);
    switch (tile) {
        case 16: return dispatch_p<16>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, vec, strides, st);
        case 32: return dispatch_p<32>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, vec, strides, st);
        case 64: return dispatch_p<64>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, vec, strides, st);
        case 128: return dispatch_p<128>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, vec, strides, st);
        default: return cudaErrorInvalidValue;
    }
}
