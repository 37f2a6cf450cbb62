// Flash attention forward for Hopper (sm_90a), fp32, on the TF32 tensor
// cores by split products (3xTF32): the fp32 route of the CUDA counterpart
// of the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_fwd (_flash_kernel).  bf16 inputs take
// flash_attention_tc.cu; the wrapper (repro_torch/kernels/flash_attention.py)
// dispatches by dtype.  Built by repro_torch/kernels/build.py with nvcc.
//
// What it computes: o = softmax(q k^T / sqrt(hd) + mask) v for fp32 q
// (B,Sq,H,hd) and k, v (B,Skv,KH,hd), GQA by reading KV head h / (H/KH).
// The online softmax carries (m, l, acc) over KV tiles in fp32 with
// NEG_INF = -1e30, and the output is acc / max(l, 1e-30), as in the Pallas
// kernel.  The causal mask is its top-left rows >= cols; columns >= Skv
// are masked.
//
// Precision.  One TF32 pass (10 mantissa bits) misses the reference's fp32
// pin (2e-5) by far.  So every operand, q, k, p and v, is split as it
// enters its fragment into x = hi + lo, both TF32 (hopper.cuh split_tf32:
// round to nearest, as cvt.rna.tf32.f32), and each product runs as three
// mma.sync m16n8k8 passes, lo*hi, hi*lo, then hi*hi, summed in fp32.  What
// is dropped (lo*lo and the rounding of lo) is about 2^-22 of each term.
// tests/test_torch_tc_precision.py emulates these roundings against the
// reference at the pin.
//
// Bound: at the serving shape (q (4,1024,32,128), causal) the work is 34.4
// GFLOP against 142.6 MB of fp32 q, k, v and o: at the TF32 rate, three
// passes take 0.209 ms and the bytes 0.043 ms, so the kernel is bound by
// operations.
//
// Design.
// - One block of 8 warps per (batch*head, 128-row q tile), the longest
//   causal tiles first; each warp owns 16 q rows.  The TPU kernel's
//   sequential KV grid axis with (m, l, acc) in VMEM becomes a loop inside
//   the block with them in registers; a causal block stops at its diagonal
//   tile, and a warp whose rows all lie above a tile skips its math.
// - Q (once), K and V tiles of 64 rows arrive by cp.async (16-byte pieces
//   where every base and stride allows it, else 4-byte ones; zero fill past
//   Sq and Skv) into a 2-stage ring: tile t+1 loads while tile t computes.
//   At hd = 128 the block takes 215 KB, one block a SM.
// - S = Q K^T runs mma.sync from shared memory with the k index permuted
//   (k t <-> hd column 4t, k t+4 <-> 4t+1, then 4t+2 and 4t+3 for the next
//   k step), so each lane reads its q and k values as one 16-byte word; rows
//   of Q and K are 16 words mod 32 apart, so those reads do not conflict.
// - wgmma takes TF32 only with both operands K-major in shared memory, and V
//   (Skv x hd) is not K-major for P V; P also leaves S's accumulators in
//   registers.  So O += P V is mma.sync too, with A = P straight from S's
//   accumulator fragments: a lane holds S columns 2t and 2t+1, so k t is kv
//   row 2t and k t+4 row 2t+1, and the lane reads V rows 2t and 2t+1.  The
//   output columns are permuted by pairs (column n of n-tile j of a 16-column
//   group is hd column 2n + j), so each V read is 8 bytes and each lane ends
//   with 4 consecutive output columns, stored as one 16-byte word.
// - The softmax runs on the accumulator fragments (row max and sum over the
//   4 lanes of a quad), in fp32 as before.
// wgmma, TMA and warp specialisation, as the bf16 kernel has them, are left
// out: the fp32 route is a parity route, not the serving one.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;       // q rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int WARPS = 8;      // 16 q rows each
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in floats: Q [BM][LDK], then K [2][BN][LDK], V [2][BN][LDV].
// LDK = 16 (mod 32): the 16-byte reads of a quarter warp (rows g, g+1, 4
// words each) cover the 32 banks.  LDV = 4 (mod 16): the 8-byte reads of a
// half warp (rows 2t, columns 2g) do.  Both keep rows 16-byte aligned.
template <int HD>
struct Cfg {
    static constexpr int LDK = HD + (48 - HD % 32) % 32;
    static constexpr int LDV = HD + 4;
    static constexpr int Q_FLOATS = BM * LDK;
    static constexpr int K_FLOATS = BN * LDK;
    static constexpr int V_FLOATS = BN * LDV;
    static constexpr size_t SMEM = (size_t)(Q_FLOATS + 2 * K_FLOATS + 2 * V_FLOATS) * 4;
};

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(FULL, x, 1);
    return x + __shfl_xor_sync(FULL, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Sq, int Skv, int H, int group,
                    int64_t qsb, int64_t qss, int64_t qsh,
                    int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh,
                    float scale, int causal, int vec) {
    using C = Cfg<HD>;
    constexpr int NG = HD / 16;  // 16-column groups of the head dim
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Ks = Qs + C::Q_FLOATS;
    float* Vs = Ks + 2 * C::K_FLOATS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const float* qp = q + b * qsb + h * qsh;
    const float* kp = k + b * ksb + (h / group) * ksh;
    const float* vp = v + b * vsb + (h / group) * vsh;

    // rows [r0, r0 + rows) of a (S, hd) matrix (row stride ss) into dst
    // (row stride ld), zeros for rows >= n.
    auto load_rows = [&](float* dst, int ld, const float* src, int64_t ss, int r0, int rows,
                         int n) {
        const uint32_t d0 = smem_u32(dst);
        if (vec) {
            for (int i = tid; i < rows * (HD / 4); i += THREADS) {
                const int r = i / (HD / 4), c = 4 * (i % (HD / 4)), row = r0 + r;
                const bool ok = row < n;
                cp_async_16(d0 + (r * ld + c) * 4, ok ? src + row * ss + c : src, ok);
            }
        } else {
            for (int i = tid; i < rows * HD; i += THREADS) {
                const int r = i / HD, c = i % HD, row = r0 + r;
                const bool ok = row < n;
                cp_async_4(d0 + (r * ld + c) * 4, ok ? src + row * ss + c : src, ok);
            }
        }
    };
    auto load_kv = [&](int tile) {
        const int s = tile % 2;
        load_rows(Ks + s * C::K_FLOATS, C::LDK, kp, kss, tile * BN, BN, Skv);
        load_rows(Vs + s * C::V_FLOATS, C::LDV, vp, vss, tile * BN, BN, Skv);
    };

    // KV tiles the block needs (its last row's, under causal) and this
    // warp's share of them (none for rows past Sq).
    const int all_tiles = (Skv + BN - 1) / BN;
    auto tiles_to = [&](int last) { return causal ? min(all_tiles, last / BN + 1) : all_tiles; };
    const int n_tiles = tiles_to(min(q0 + BM, Sq) - 1);
    const int r0 = q0 + warp * 16;  // this warp's first q row
    const int my_tiles = r0 >= Sq ? 0 : tiles_to(min(r0 + 16, Sq) - 1);

    load_rows(Qs, C::LDK, qp, qss, q0, BM, Sq);
    load_kv(0);
    cp_async_commit();

    float acc[2 * NG][4];  // O: rows g, g + 8; n-tile 2c + j (see the note)
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    const float* qa = Qs + (warp * 16 + g) * C::LDK + 4 * t;  // row g; row g + 8 below
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            load_kv(it + 1);  // into the stage tile it - 1 used, consumed by now
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // tile it (and Q) has landed for every thread
        if (it < my_tiles) {
            const float* Kt = Ks + (it % 2) * C::K_FLOATS;
            const float* Vt = Vs + (it % 2) * C::V_FLOATS;
            const int k0 = it * BN;

            // ---- S = Q K^T over 8 n-tiles of 8 kv columns ----
            float s[BN / 8][4];
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
            for (int kk = 0; kk < NG; ++kk) {
                const float4 xa = *reinterpret_cast<const float4*>(qa + 16 * kk);
                const float4 xb = *reinterpret_cast<const float4*>(qa + 8 * C::LDK + 16 * kk);
                uint32_t ah0[4], al0[4], ah1[4], al1[4];
                split_tf32(xa.x, ah0[0], al0[0]);
                split_tf32(xb.x, ah0[1], al0[1]);
                split_tf32(xa.y, ah0[2], al0[2]);
                split_tf32(xb.y, ah0[3], al0[3]);
                split_tf32(xa.z, ah1[0], al1[0]);
                split_tf32(xb.z, ah1[1], al1[1]);
                split_tf32(xa.w, ah1[2], al1[2]);
                split_tf32(xb.w, ah1[3], al1[3]);
#pragma unroll
                for (int nt = 0; nt < BN / 8; ++nt) {
                    const float4 kv =
                        *reinterpret_cast<const float4*>(Kt + (8 * nt + g) * C::LDK + 16 * kk + 4 * t);
                    uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
                    split_tf32(kv.x, bh0[0], bl0[0]);
                    split_tf32(kv.y, bh0[1], bl0[1]);
                    split_tf32(kv.z, bh1[0], bl1[0]);
                    split_tf32(kv.w, bh1[1], bl1[1]);
                    mma_3xtf32(s[nt], ah0, al0, bh0, bl0);
                    mma_3xtf32(s[nt], ah1, al1, bh1, bl1);
                }
            }

            // ---- online softmax on the fragments: rows g (i = 0), g + 8 ----
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = r0 + g + 8 * i;
                float mx = NEG_INF;
#pragma unroll
                for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) {
                        const int col = k0 + 8 * nt + 2 * t + jj;
                        const bool valid = col < Skv && (!causal || row >= col);
                        float& x = s[nt][2 * i + jj];
                        x = valid ? x * scale : NEG_INF;
                        mx = fmaxf(mx, x);
                    }
                const float m_new = fmaxf(m[i], quad_max(mx));
                const float corr = expf(m[i] - m_new);
                float sum = 0.f;
#pragma unroll
                for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) {
                        float& x = s[nt][2 * i + jj];
                        x = expf(x - m_new);
                        sum += x;
                    }
                l[i] = l[i] * corr + quad_sum(sum);
                m[i] = m_new;
#pragma unroll
                for (int j = 0; j < 2 * NG; ++j) {
                    acc[j][2 * i] *= corr;
                    acc[j][2 * i + 1] *= corr;
                }
            }

            // ---- O += P V: k step nt is kv rows 8nt + 2t (k t), + 1 (k t+4) ----
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
                uint32_t ph[4], pl[4];
                split_tf32(s[nt][0], ph[0], pl[0]);
                split_tf32(s[nt][2], ph[1], pl[1]);
                split_tf32(s[nt][1], ph[2], pl[2]);
                split_tf32(s[nt][3], ph[3], pl[3]);
                const float* v0 = Vt + (8 * nt + 2 * t) * C::LDV + 2 * g;
#pragma unroll
                for (int c = 0; c < NG; ++c) {
                    const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * c);
                    const float2 x1 = *reinterpret_cast<const float2*>(v0 + C::LDV + 16 * c);
                    uint32_t bh[2], bl[2];
                    split_tf32(x0.x, bh[0], bl[0]);
                    split_tf32(x1.x, bh[1], bl[1]);
                    mma_3xtf32(acc[2 * c], ph, pl, bh, bl);
                    split_tf32(x0.y, bh[0], bl[0]);
                    split_tf32(x1.y, bh[1], bl[1]);
                    mma_3xtf32(acc[2 * c + 1], ph, pl, bh, bl);
                }
            }
        }
        __syncthreads();  // tile it is consumed before its stage is refilled
    }

    // Epilogue: columns 16c + 4t .. + 3 of rows g and g + 8, as one float4.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r0 + g + 8 * i;
        if (row < Sq) {
            const float denom = fmaxf(l[i], 1e-30f);
            float* op = o + ((int64_t)(b * Sq + row) * H + h) * HD + 4 * t;
#pragma unroll
            for (int c = 0; c < NG; ++c)
                *reinterpret_cast<float4*>(op + 16 * c) =
                    make_float4(acc[2 * c][2 * i] / denom, acc[2 * c + 1][2 * i] / denom,
                                acc[2 * c][2 * i + 1] / denom, acc[2 * c + 1][2 * i + 1] / denom);
        }
    }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Sq, int Skv, int H, int KH,
                   int64_t qsb, int64_t qss, int64_t qsh,
                   int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh,
                   int causal, float scale, int vec, cudaStream_t stream) {
    constexpr size_t smem = Cfg<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Sq + BM - 1) / BM);
    flash_tf32x3_kernel<HD><<<grid, THREADS, smem, stream>>>(
        q, k, v, o, Sq, Skv, H, H / KH, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale,
        causal, vec);
    return cudaGetLastError();
}

}  // namespace

// fp32 q, k, v and o.  Strides are in elements; the head dim is contiguous
// and o is a contiguous (B, Sq, H, hd) tensor.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int KH, int hd,
                                   int64_t qsb, int64_t qss, int64_t qsh,
                                   int64_t ksb, int64_t kss, int64_t ksh,
                                   int64_t vsb, int64_t vss, int64_t vsh,
                                   int causal, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // 16-byte copies need 16-byte aligned bases and strides of whole 4-float units
    const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                    ((qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh) % 4 == 0);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
#define REPRO_FLASH_HD(N)                                                                  \
    case N:                                                                                \
        return launch<N>(qf, kf, vf, of, B, Sq, Skv, H, KH, qsb, qss, qsh, ksb, kss, ksh, \
                         vsb, vss, vsh, causal, scale, vec, st);
    switch (hd) {
        REPRO_FLASH_HD(16)
        REPRO_FLASH_HD(32)
        REPRO_FLASH_HD(64)
        REPRO_FLASH_HD(112)
        REPRO_FLASH_HD(128)
        default:
            return cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_HD
}
