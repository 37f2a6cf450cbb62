// Mamba2 SSD chunk scan forward for Hopper (sm_90a) on the tensor cores,
// bf16: the serving route of the CUDA counterpart of the Pallas TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_scan_fwd (_ssd_kernel).  fp32 inputs
// take ssd_scan.cu, whose exact fp32 arithmetic holds the reference's fp32
// pin; the wrapper (repro_torch/kernels/ssd_scan.py) dispatches by dtype.
// Built by repro_torch/kernels/build.py with nvcc.
//
// What it computes is what ssd_scan.cu computes, for each (batch b, head h)
// with h_{-1} = 0, in chunks of L steps:
//   W       = mask(C B^T o exp(segsum) o dt)   (masked causal BEFORE exp)
//   y       = W x + (C h^T) * exp(cumsum)      (h from before the update)
//   h       = h exp(a_L) + x^T (B dt exp(a_L - cumsum))
// for bf16 x (B,S,H,P), B, C (B,S,N) and fp32 dt (B,S,H), A = a_neg (H,); y
// in bf16 and the final state h_final (B,H,P,N) in fp32.  Any S: the ragged
// last chunk is masked as dt = 0 steps (decay 1, no input).
//
// Precision.  Every product runs on mma.sync m16n8k16 (bf16 in, fp32 sum).
// x, B and C are exact in bf16.  W is formed in fp32 and split into a bf16
// hi + lo pair (W x = W_hi x + W_lo x): rounding it once puts y outside the
// bf16 pin where |y| is small at mamba2's draws, since the error scales with
// the terms.  The carried state is split the same way for C h^T (rounding
// it once fails the bf16 pin at the serving shape, where |h| reaches ~100
// and C h^T sums 128 such terms).  The scaled B (B dt exp(a_L - cumsum)) is
// split into hi + lo for the state product, which holds h_final to the fp32
// pin (1e-4), as both sides form it in fp32.  tests/test_torch_tc_precision.py emulates these roundings
// against the reference.
//
// Bound: at the serving shape (mamba2-370m, B=8, S=2048, H=32, P=64, N=128,
// L=64) the scan moves ~153 MB and does ~22 GFLOP, so it is bound by bytes.
//
// Design.  One block of 8 warps per (b, h) walks the chunks in order, since
// the state carries across them.
// - The state h^T (N x P, fp32) lives in the state product's accumulator
//   fragments across all chunks: warp w owns rows n in [16w, 16w + 16).
//   Each chunk it is scaled by exp(a_L), the new product is accumulated into
//   it, and a bf16 hi + lo copy is written to shared memory for the next
//   C h^T.
// - The chunk tiles stay bf16 in shared memory: x (L x P), B and C (L x N)
//   and dt, fetched by cp.async into a 2-stage ring, so chunk c+1 loads
//   while chunk c computes (one stage at L = 128, where two do not fit).
//   Rows are not padded: the 16-byte pieces of a row are XOR-swizzled by
//   the row index, so the 8 rows an ldmatrix reads hit distinct banks.  At
//   L = 64 the block takes 113 KB, so two blocks fit on an SM and the 256
//   blocks of the serving shape run in one wave.
// - A chunk step, between three block barriers:
//   1. warp 0 scans dt A (cumsum) and forms the state weights
//      f_l = dt_l exp(a_L - cumsum_l); every warp forms its share of the
//      causal 16 x 16 blocks of G = C B^T and its y tile's C h^T;
//   2. the warps write W = mask(G exp(segsum) dt) as bf16 hi and lo over C,
//      which no one reads any more;
//   3. y = (C h^T) exp(cumsum) + W x is written for the valid rows, and the
//      state update runs: the A operand (B f)^T is loaded from B with
//      ldmatrix.trans, scaled by f and split into hi + lo in registers.
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

// The 16-byte piece c of row r of a tile with nch pieces a row sits at
// piece c ^ (r & mask), mask + 1 the largest power of two (at most 8) that
// divides nch, so the XOR stays inside the row.
__device__ __forceinline__ int swz(int r, int c, int nch) {
    return c ^ (r & (min(nch & -nch, 8) - 1));
}

// Shared memory: STAGES x {x, B, C (then W hi and lo), dt}, then the bf16
// hi and lo state copies, the cumsum and the state weights.  Offsets in
// bytes; rows unpadded (swizzled, see swz).
template <int LT, int P>
struct Layout {
    static constexpr int STAGES = LT == 128 ? 1 : 2;
    static constexpr int XS = P * 2;                          // x and state rows
    static constexpr int WS = LT * 2;                         // W rows
    static constexpr int NS = LT / 16;                        // 16-row strips
    static constexpr int NG = WARPS / NS;                     // warps per strip
    static constexpr int PT = P / 8;                          // n8 tiles over P
    static constexpr int YT = (PT + NG - 1) / NG;             // y tiles a warp owns
    static constexpr int NBLK = NS * (NS + 1) / 2;            // causal G blocks
    static constexpr int GB = (NBLK + WARPS - 1) / WARPS;     // G blocks a warp owns
    __host__ __device__ static int nsb(int N) { return N * 2; }  // B and C rows
    __host__ __device__ static int b_off() { return LT * XS; }
    __host__ __device__ static int cw_off(int N) { return b_off() + LT * nsb(N); }
    __host__ __device__ static int dt_off(int N) {
        return cw_off(N) + cmax(LT * nsb(N), 2 * LT * WS);
    }
    __host__ __device__ static int stage_bytes(int N) { return dt_off(N) + LT * 4; }
    __host__ __device__ static int hb_off(int N) { return STAGES * stage_bytes(N); }
    __host__ __device__ static int acum_off(int N) { return hb_off(N) + 2 * N * XS; }
    __host__ __device__ static int f_off(int N) { return acum_off(N) + LT * 4; }
    __host__ __device__ static int smem_bytes(int N) { return f_off(N) + LT * 4; }
};

template <int LT, int P>
__global__ void __launch_bounds__(THREADS, LT == 128 ? 1 : 2)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_neg, const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
              float* __restrict__ h_out, int S, int H, int N, int chunk,
              int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss, int64_t dsh,
              int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
    using Ly = Layout<LT, P>;
    extern __shared__ __align__(16) uint8_t smem[];
    const uint32_t sbase = smem_u32(smem);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, qq = lane % 4;  // fragment row, column pair
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const float a = a_neg[h];
    const int NK = N / 16;                   // k-steps over the state size
    const __nv_bfloat16* xp = x + b * xsb + h * xsh;
    const float* dp = dt + b * dsb + h * dsh;
    const __nv_bfloat16* bp = Bm + b * bsb;
    const __nv_bfloat16* cp = Cm + b * csb;
    __nv_bfloat16* yp = y + ((int64_t)b * S * H + h) * P;  // step t at yp + t * H * P
    const int64_t ys = (int64_t)H * P;
    float* acum = reinterpret_cast<float*>(smem + Ly::acum_off(N));
    float* fsc = reinterpret_cast<float*>(smem + Ly::f_off(N));
    const uint32_t hb = sbase + Ly::hb_off(N), hl = hb + N * Ly::XS;  // state hi, lo
    constexpr int XCH = P / 8, WCH = LT / 8;  // 16-byte pieces of x/state and W rows
    const int NCH = N / 8;                     // and of B and C rows

    // ldmatrix row and 16-byte piece selectors of this lane: the A pattern
    // (rows 0-15 by lane % 16, piece by lane / 16) and the B pattern (rows by
    // lane % 8 and lane / 16, piece by (lane / 8) % 2).
    const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_pc = lane / 16;
    const int b_row = (lane % 8) + 8 * (lane / 16), b_pc = (lane / 8) % 2;
    // Address of piece pc of row r in a tile at t with rows of nch pieces.
    auto at = [](uint32_t t, int r, int pc, int nch) {
        return t + r * nch * 16 + swz(r, pc, nch) * 16;
    };

    auto stage_off = [&](int c) { return (c % Ly::STAGES) * Ly::stage_bytes(N); };
    auto issue = [&](int c) {  // cp.async of chunk c into its stage, zero past S
        const uint32_t s0 = sbase + stage_off(c);
        const int t0 = c * chunk, valid = min(chunk, S - t0);
        for (int i = tid; i < LT * XCH; i += THREADS) {
            const int l = i / XCH, ch = i % XCH;
            const bool ok = l < valid;
            cp_async_16(at(s0, l, ch, XCH), ok ? xp + (t0 + l) * xss + ch * 8 : xp, ok);
        }
        for (int i = tid; i < LT * NCH; i += THREADS) {
            const int l = i / NCH, ch = i % NCH;
            const bool ok = l < valid;
            cp_async_16(at(s0 + Ly::b_off(), l, ch, NCH), ok ? bp + (t0 + l) * bss + ch * 8 : bp, ok);
            cp_async_16(at(s0 + Ly::cw_off(N), l, ch, NCH), ok ? cp + (t0 + l) * css + ch * 8 : cp,
                        ok);
        }
        for (int l = tid; l < LT; l += THREADS) {
            const bool ok = l < valid;
            cp_async_4(s0 + Ly::dt_off(N) + l * 4, ok ? dp + (t0 + l) * dss : dp, ok);
        }
        cp_async_commit();
    };

    for (int i = tid; i < 2 * N * Ly::XS / 4; i += THREADS) st_shared_u32(hb + 4 * i, 0u);
    float hacc[Ly::PT][4];  // h^T rows n = 16 warp + gq (+8), columns p of tile j
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
        const uint32_t s0 = sbase + stage_off(c);
        const uint32_t xs = s0, bs = s0 + Ly::b_off(), cw = s0 + Ly::cw_off(N);
        const float* dts = reinterpret_cast<const float*>(smem + stage_off(c) + Ly::dt_off(N));

        // ---- 1. cumsum and state weights (warp 0); G blocks; C h^T ----
        if (warp == 0) {
            // Each lane sums PER consecutive steps, then the lanes' totals are
            // scanned by shuffles (as ssd_scan.cu does).
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
                for (int kk = 0; kk < NK; ++kk) {
                    uint32_t af[4], bf[4];
                    ldmatrix_x4(af, at(cw, lb * 16 + a_row, 2 * kk + a_pc, NCH));
                    ldmatrix_x4(bf, at(bs, mb * 16 + b_row, 2 * kk + b_pc, NCH));
                    const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
                    mma_bf16_16816(gacc[u][0], af, b0);
                    mma_bf16_16816(gacc[u][1], af, b1);
                }
            }
        }

        float yacc[Ly::YT][4];
#pragma unroll
        for (int jt = 0; jt < Ly::YT; ++jt)
#pragma unroll
            for (int r = 0; r < 4; ++r) yacc[jt][r] = 0.f;
        for (int kk = 0; kk < NK; ++kk) {
            uint32_t af[4];
            ldmatrix_x4(af, at(cw, strip * 16 + a_row, 2 * kk + a_pc, NCH));
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                const int j = grp * Ly::YT + jt;
                if (j < Ly::PT) {
                    uint32_t bhi[2], blo[2];
                    ldmatrix_x2_trans(bhi, at(hb, kk * 16 + a_row, j, XCH));
                    ldmatrix_x2_trans(blo, at(hl, kk * 16 + a_row, j, XCH));
                    mma_bf16_16816(yacc[jt], af, bhi);
                    mma_bf16_16816(yacc[jt], af, blo);
                }
            }
        }
        __syncthreads();  // C is read; the cumsum and weights are written

        // ---- 2. W = mask(G exp(segsum) dt) as bf16 hi + lo over C ----
        const uint32_t wh = cw, wl = cw + LT * Ly::WS;
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
                        const int l = lb * 16 + gq + 8 * i, m = mb * 16 + 8 * tt + 2 * qq;
                        const float w0 = m <= l ? gacc[u][tt][2 * i] * expf(acum[l] - acum[m]) *
                                                      dts[m]
                                                : 0.f;
                        const float w1 = m + 1 <= l ? gacc[u][tt][2 * i + 1] *
                                                          expf(acum[l] - acum[m + 1]) * dts[m + 1]
                                                    : 0.f;
                        const uint32_t hi = pack_bf16(w0, w1);
                        const float2 hv = unpack_bf16(hi);
                        const uint32_t off = at(0, l, m / 8, WCH) + (m % 8) * 2;
                        st_shared_u32(wh + off, hi);
                        st_shared_u32(wl + off, pack_bf16(w0 - hv.x, w1 - hv.y));
                    }
            }
        }
        __syncthreads();  // W is written

        // ---- 3. y = (C h^T) exp(cumsum) + W x; the state update ----
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float e = expf(acum[strip * 16 + gq + 8 * i]);
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                yacc[jt][2 * i] *= e;
                yacc[jt][2 * i + 1] *= e;
            }
        }
        for (int kb = 0; kb <= strip; ++kb) {  // W is zero above the diagonal
            uint32_t ah[4], al[4];
            ldmatrix_x4(ah, at(wh, strip * 16 + a_row, 2 * kb + a_pc, WCH));
            ldmatrix_x4(al, at(wl, strip * 16 + a_row, 2 * kb + a_pc, WCH));
#pragma unroll
            for (int jt = 0; jt < Ly::YT; ++jt) {
                const int j = grp * Ly::YT + jt;
                if (j < Ly::PT) {
                    uint32_t bf[2];
                    ldmatrix_x2_trans(bf, at(xs, kb * 16 + a_row, j, XCH));
                    mma_bf16_16816(yacc[jt], ah, bf);
                    mma_bf16_16816(yacc[jt], al, bf);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int l = strip * 16 + gq + 8 * i;
            if (l < valid) {
#pragma unroll
                for (int jt = 0; jt < Ly::YT; ++jt) {
                    const int j = grp * Ly::YT + jt;
                    if (j < Ly::PT)
                        *reinterpret_cast<uint32_t*>(yp + (t0 + l) * ys + j * 8 + 2 * qq) =
                            pack_bf16(yacc[jt][2 * i], yacc[jt][2 * i + 1]);
                }
            }
        }

        if (warp < NK) {
            const float e_end = expf(acum[LT - 1]);
#pragma unroll
            for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) hacc[j][r] *= e_end;
#pragma unroll
            for (int kb = 0; kb < Ly::NS; ++kb) {
                // A = (B f)^T for rows n of this warp's strip, k = steps of kb.
                uint32_t raw[4], ahi[4], alo[4];
                ldmatrix_x4_trans(raw, at(bs, kb * 16 + b_row, 2 * warp + b_pc, NCH));
                const float f0 = fsc[kb * 16 + 2 * qq], f1 = fsc[kb * 16 + 2 * qq + 1];
                const float f8 = fsc[kb * 16 + 2 * qq + 8], f9 = fsc[kb * 16 + 2 * qq + 9];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float2 v = unpack_bf16(raw[r]);
                    const float v0 = v.x * (r < 2 ? f0 : f8), v1 = v.y * (r < 2 ? f1 : f9);
                    ahi[r] = pack_bf16(v0, v1);
                    const float2 hv = unpack_bf16(ahi[r]);
                    alo[r] = pack_bf16(v0 - hv.x, v1 - hv.y);
                }
#pragma unroll
                for (int j = 0; j < Ly::PT; ++j) {
                    uint32_t bf[2];
                    ldmatrix_x2_trans(bf, at(xs, kb * 16 + a_row, j, XCH));
                    mma_bf16_16816(hacc[j], ahi, bf);
                    mma_bf16_16816(hacc[j], alo, bf);
                }
            }
#pragma unroll
            for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint32_t off = at(0, warp * 16 + gq + 8 * i, j, XCH) + 4 * qq;
                    const uint32_t hi = pack_bf16(hacc[j][2 * i], hacc[j][2 * i + 1]);
                    const float2 hv = unpack_bf16(hi);
                    st_shared_u32(hb + off, hi);
                    st_shared_u32(hl + off, pack_bf16(hacc[j][2 * i] - hv.x,
                                                      hacc[j][2 * i + 1] - hv.y));
                }
        }
    }

    if (warp < NK) {
        float* ho = h_out + (int64_t)blockIdx.x * P * N;
#pragma unroll
        for (int j = 0; j < Ly::PT; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
                    ho[(j * 8 + 2 * qq + jj) * N + warp * 16 + gq + 8 * i] = hacc[j][2 * i + jj];
    }
}

template <int LT, int P>
int launch(const void* x, const void* dt, const void* a_neg, const void* Bm, const void* Cm,
           void* y, void* h_out, int B, int S, int H, int N, int chunk, const int64_t* st,
           cudaStream_t stream) {
    const int smem = Layout<LT, P>::smem_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(ssd_tc_kernel<LT, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // All of the SM's 228 KB as shared memory: two 113 KB blocks at L = 64.
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ssd_tc_kernel<LT, P>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ssd_tc_kernel<LT, P><<<B * H, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_neg), static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(h_out), S, H, N, chunk, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9]);
    return cudaGetLastError();
}

template <int LT>
int dispatch_p(const void* x, const void* dt, const void* a_neg, const void* Bm, const void* Cm,
               void* y, void* h_out, int B, int S, int H, int P, int N, int chunk,
               const int64_t* st, cudaStream_t stream) {
    switch (P) {
        case 16: return launch<LT, 16>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, st, stream);
        case 32: return launch<LT, 32>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, st, stream);
        case 64: return launch<LT, 64>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, N, chunk, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// bf16 x, Bm, Cm and y; fp32 dt, a_neg and h_out.  P is 16, 32 or 64; N a
// multiple of 16 up to 128; tile the chunk tile (16, 32, 64 or 128, at
// least chunk).  strides holds, in elements, x's (batch, step, head), dt's
// (batch, step, head), B's (batch, step) and C's (batch, step); the last
// dims of x, B and C are contiguous, their bases 16-byte aligned and their
// strides multiples of 8 elements (cp.async moves 16 bytes); y is a
// contiguous (B, S, H, P) tensor and h_out a contiguous (B, H, P, N) one.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ssd_scan_tc_fwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                               const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
                               int N, int chunk, int tile, const int64_t* strides, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N % 16 || N < 16 || N > MAX_N || chunk < 1 || chunk > tile || S < 1)
        return cudaErrorInvalidValue;
    switch (tile) {
        case 16: return dispatch_p<16>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, strides, st);
        case 32: return dispatch_p<32>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, strides, st);
        case 64: return dispatch_p<64>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, strides, st);
        case 128: return dispatch_p<128>(x, dt, a_neg, Bm, Cm, y, h_out, B, S, H, P, N, chunk, strides, st);
        default: return cudaErrorInvalidValue;
    }
}
