// Flash attention forward for Hopper (sm_90a) on the tensor cores, bf16:
// the serving route of the CUDA counterpart of the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_fwd (_flash_kernel).
// fp32 inputs take flash_attention.cu, whose exact fp32 arithmetic holds the
// reference's fp32 pin; the wrapper (repro_torch/kernels/flash_attention.py)
// dispatches by dtype.  Built by repro_torch/kernels/build.py with nvcc.
//
// What it computes: o = softmax(q k^T / sqrt(hd) + mask) v for bf16 q
// (B,Sq,H,hd) and k, v (B,Skv,KH,hd), GQA by reading KV head h / (H/KH).
// The online softmax runs in fp32 with the same arithmetic as the CUDA-core
// kernel (NEG_INF = -1e30, the top-left causal mask rows >= cols, columns
// >= Skv masked, output acc / max(l, 1e-30)); P is rounded to bf16 for the
// P V product, whose sum is fp32.  That rounding is the one new source of
// error (tests/test_torch_tc_precision.py emulates it against the pin).
//
// Bound: at the serving shape (glm4-9b, B=4, S=1024, H=32, KH=2, hd=128) the
// causal work is 34.4 GFLOP against ~71 MB, so the kernel is bound by
// operations, and only wgmma reaches the card's bf16 tensor-core rate.
//
// Design (FA3's structure without its ping-pong scheduling or warp
// specialisation; those are later work):
// - One block per (batch*head, 128-row q tile), the longest causal tiles
//   first, two blocks a SM.  Two consumer warpgroups each own 64 q rows.
// - Q, K and V arrive by TMA (tensor maps encoded on the host over the
//   (B,S,H,hd) layout through the strides given; zero fill covers ragged
//   tiles).  K and V of 64 rows sit in a 2-stage ring with a full barrier
//   per tensor and stage and an empty barrier per stage; thread 0 issues
//   tile t+2 into a stage as soon as both warpgroups have released it, so
//   loads overlap the math.
// - S = Q K^T: wgmma m64n64k16, both operands K-major from swizzled shared
//   memory.  The swizzle follows the row size: rows of min(hd, 64) bf16
//   (32, 64 or 128 B) and two column boxes at hd = 112 and 128 (at 112 the
//   second box is zero-filled past column 112).
// - The softmax runs on the accumulator fragments in registers (row max and
//   sum over the 4 lanes of a quad); P is repacked in registers into the A
//   operand of O += P V: wgmma m64nNk16 with V MN-major (transposed B), one
//   product per 64-column box of V.
// - The epilogue writes the rows < Sq in bf16 straight from the fragments.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;       // q rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int WG_ROWS = 64;   // q rows per consumer warpgroup
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr float NEG_INF = -1e30f;

// A head dim that is not a multiple of 64 above 64 (112) is laid out at
// NB * CB = 128 columns: the last box runs past hd, TMA zero-fills its
// columns >= hd (the map's inner dim is the true hd) and still counts the
// whole box towards the barrier's transaction bytes.
template <int HD>
struct Cfg {
    static constexpr int CB = HD < 64 ? HD : 64;  // columns of a box
    static constexpr int NB = (HD + CB - 1) / CB; // boxes across hd
    static constexpr int HDP = NB * CB;           // columns in shared memory
    static constexpr int RB = CB * 2;             // bytes of a box row
    static constexpr uint32_t LAYOUT = gmma_layout(RB);
    static constexpr int Q_BYTES = BM * HDP * 2;
    static constexpr int KV_BYTES = BN * HDP * 2;
    static constexpr int BAR_OFF = Q_BYTES + 4 * KV_BYTES;
    // 1 KB of slack to align the tiles to 1024 B, then 7 barriers.
    static constexpr int SMEM = 1024 + BAR_OFF + 64;
};

// Two blocks a SM (96 KB of shared memory and at most 128 registers a
// thread each): at hd = 128 ptxas then spills 28 bytes, and the serving
// shape still runs faster than with one block of 168 registers (PERF.md).
// hd = 112 holds the same 128-column accumulator as hd = 128 (its last 16
// columns are products with zero V columns, never stored).
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_tc_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                int Sq, int Skv, int H, int group, float scale, int causal) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    // Q, then the ring: K stage s at sk + s * KV_BYTES, V stage s at sv + ...
    const uint32_t sq = base;
    const uint32_t sk = base + C::Q_BYTES, sv = sk + 2 * C::KV_BYTES;
    // Barriers: q_full, then k_full[s], v_full[s], empty[s] at + 8 s.
    const uint32_t q_full = base + C::BAR_OFF;
    const uint32_t k_full = q_full + 8, v_full = q_full + 24, empty = q_full + 40;

    const int tid = threadIdx.x;
    const int g = tid / 128, tw = tid % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
    const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / group;

    // KV tiles each warpgroup needs (stop at its causal diagonal; none for
    // rows past Sq), and the block's count, which the loads follow.
    const int all_tiles = (Skv + BN - 1) / BN;
    auto tiles_of = [&](int w) {
        const int r0 = q0 + w * WG_ROWS;
        return r0 >= Sq ? 0 : causal ? min(all_tiles, (r0 + WG_ROWS - 1) / BN + 1) : all_tiles;
    };
    const int n_tiles = max(tiles_of(0), tiles_of(1));
    const int my_tiles = tiles_of(g);

    if (tid == 0) {
        mbar_init(q_full, 1);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(empty + 8 * s, THREADS / 32);  // one arrival per warp
        }
        fence_barrier_init();
    }
    __syncthreads();

    const CUtensorMap* map_k = &tmk;  // the maps stay in parameter space
    const CUtensorMap* map_v = &tmv;
    auto load_kv = [&](int t) {
        const int s = t & 1;
        const uint32_t kb = k_full + 8 * s, vb = v_full + 8 * s;
        mbar_expect_tx(kb, C::KV_BYTES);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx)
            tma_load_4d(sk + s * C::KV_BYTES + bx * BN * C::RB, map_k, kb, bx * C::CB, kh, t * BN, b);
        mbar_expect_tx(vb, C::KV_BYTES);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx)
            tma_load_4d(sv + s * C::KV_BYTES + bx * BN * C::RB, map_v, vb, bx * C::CB, kh, t * BN, b);
    };
    if (tid == 0) {
        mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx)
            tma_load_4d(sq + bx * BM * C::RB, &tmq, q_full, bx * C::CB, h, q0, b);
        for (int t = 0; t < min(2, n_tiles); ++t) load_kv(t);
    }

    // This thread's rows of the warpgroup's 64: r_lo and r_lo + 8.
    const int r_lo = q0 + g * WG_ROWS + warp * 16 + lane / 4;
    const int c_in = 2 * (lane % 4);  // first column of a pair in each 8-column group
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float oacc[C::NB][C::CB / 2];
#pragma unroll
    for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
        for (int i = 0; i < C::CB / 2; ++i) oacc[bx][i] = 0.f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        const uint32_t ph = (t >> 1) & 1;
        const int k0 = t * BN;
        const uint32_t k_tile = sk + s * C::KV_BYTES, v_tile = sv + s * C::KV_BYTES;
        if (t < my_tiles) {
            // ---- S = Q K^T (hd / 16 k-steps: the zero-filled columns
            // past hd are never read) ----
            float sacc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
            mbar_wait(k_full + 8 * s, ph);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int col = kk * 16, bx = col / C::CB;
                const uint32_t within = (col % C::CB) * 2;
                const uint64_t da = gmma_desc(sq + bx * BM * C::RB + g * WG_ROWS * C::RB + within,
                                              16, 8 * C::RB, C::LAYOUT);
                const uint64_t db = gmma_desc(k_tile + bx * BN * C::RB + within, 16, 8 * C::RB,
                                              C::LAYOUT);
                wgmma_ss_m64n64(sacc, da, db, kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int i = 0; i < 32; ++i) fence_operand(sacc[i]);

            // ---- online softmax on the fragments: sacc[4k + 2i + j] is row
            // r_lo + 8i, column k0 + 8k + c_in + j ----
            const bool need_mask =
                k0 + BN > Skv || (causal && k0 + BN - 1 > q0 + g * WG_ROWS);
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int idx = 4 * k + 2 * i + j;
                        float v = sacc[idx] * scale;
                        if (need_mask) {
                            const int col = k0 + 8 * k + c_in + j, row = r_lo + 8 * i;
                            if (col >= Skv || (causal && row < col)) v = NEG_INF;
                        }
                        sacc[idx] = v;
                        mx[i] = fmaxf(mx[i], v);
                    }
            float corr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                corr[i] = expf(m[i] - m_new);
                m[i] = m_new;
            }
            float sum[2] = {0.f, 0.f};
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int idx = 4 * k + 2 * i + j;
                        sacc[idx] = expf(sacc[idx] - m[i]);
                        sum[i] += sacc[idx];
                    }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
                sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
                l[i] = l[i] * corr[i] + sum[i];
            }
#pragma unroll
            for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
                for (int k = 0; k < C::CB / 8; ++k)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        oacc[bx][4 * k + 2 * i] *= corr[i];
                        oacc[bx][4 * k + 2 * i + 1] *= corr[i];
                    }
            // P in bf16 as the A operand of m64nNk16, one k-step per 16 columns.
            uint32_t pa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
                pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
                pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
                pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
            }

            // ---- O += P V ----
            mbar_wait(v_full + 8 * s, ph);
#pragma unroll
            for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
                for (int i = 0; i < C::CB / 2; ++i) fence_operand(oacc[bx][i]);
            wgmma_fence();
#pragma unroll
            for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) {
                    const uint64_t db = gmma_desc(v_tile + bx * BN * C::RB + kk * 16 * C::RB,
                                                  BN * C::RB, 8 * C::RB, C::LAYOUT);
                    WgmmaRS<C::CB>::run(oacc[bx], pa[kk], db);
                }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
                for (int i = 0; i < C::CB / 2; ++i) fence_operand(oacc[bx][i]);
        } else {
            // Past this warpgroup's diagonal: release the stage only once its
            // tile has landed, so this release cannot count towards the
            // release of the tile two steps back.
            mbar_wait(v_full + 8 * s, ph);
        }
        // Release the stage; thread 0 refills it with tile t + 2.
        if (lane == 0) mbar_arrive(empty + 8 * s);
        if (tid == 0 && t + 2 < n_tiles) {
            mbar_wait(empty + 8 * s, ph);
            load_kv(t + 2);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r_lo + 8 * i;
        if (row < Sq && my_tiles > 0) {
            const float inv = 1.f / fmaxf(l[i], 1e-30f);
            __nv_bfloat16* op = o + ((int64_t)(b * Sq + row) * H + h) * HD;
#pragma unroll
            for (int bx = 0; bx < C::NB; ++bx)
#pragma unroll
                for (int k = 0; k < C::CB / 8; ++k) {
                    const int col = bx * C::CB + 8 * k + c_in;
                    if (bx * C::CB + 8 * k < HD)  // the padded columns stay unstored
                        *reinterpret_cast<uint32_t*>(op + col) = pack_bf16(
                            oacc[bx][4 * k + 2 * i] * inv, oacc[bx][4 * k + 2 * i + 1] * inv);
                }
        }
    }
}

// A rank-4 tensor map {hd, heads, seq, batch} over a bf16 (B,S,heads,hd)
// tensor with the given element strides; boxes of {min(hd,64), 1, rows, 1}.
// The inner dim is the true hd, so a box past it is zero-filled.
template <int HD>
CUresult encode(CUtensorMap* map, const void* ptr, int heads, int seq, int batch, int64_t sb,
                int64_t ss, int64_t sh, int rows) {
    using C = Cfg<HD>;
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)seq,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::CB, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swz = C::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : C::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                  dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int KH, const int64_t* st, int causal, float scale, cudaStream_t stream) {
    CUtensorMap tmq, tmk, tmv;
    CUresult r = encode<HD>(&tmq, q, H, Sq, B, st[0], st[1], st[2], BM);
    if (r == CUDA_SUCCESS) r = encode<HD>(&tmk, k, KH, Skv, B, st[3], st[4], st[5], BN);
    if (r == CUDA_SUCCESS) r = encode<HD>(&tmv, v, KH, Skv, B, st[6], st[7], st[8], BN);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    constexpr int smem = Cfg<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Sq + BM - 1) / BM);
    flash_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(
        tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, H / KH, scale, causal);
    return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v; strides (in elements) holds q's, k's and v's (batch, step,
// head) strides; the head dim is contiguous, every stride a multiple of 8
// elements and every base 16-byte aligned (TMA's rule; the wrapper checks).
// o is a contiguous (B, Sq, H, hd) bf16 tensor.  Returns 0 on success, a
// cudaError_t from the launch, or minus the CUresult of a tensor map that
// could not be encoded.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int KH, int hd,
                                      const int64_t* strides, int causal, float scale,
                                      void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, B, Sq, Skv, H, KH, strides, causal, scale, st);
        case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, KH, strides, causal, scale, st);
        case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, KH, strides, causal, scale, st);
        case 112: return launch<112>(q, k, v, o, B, Sq, Skv, H, KH, strides, causal, scale, st);
        case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, KH, strides, causal, scale, st);
        default: return cudaErrorInvalidValue;
    }
}
