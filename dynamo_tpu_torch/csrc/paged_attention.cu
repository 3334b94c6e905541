// Paged attention over a block-table KV cache, for Hopper (sm_90a): the
// scalar design (CUDA cores, f32 products).
//
// Replaces the TPU kernel dynamo_tpu/ops/paged_attention.py
// (paged_attention_kernel, body _kernel) for f32 q over its f32
// model-precision cache (route scalar_float). Every other route, f32 q over
// an int8 or packed-int4 cache included, runs the tensor-core design in
// paged_attention_mma.cu (its head comment has the table of routes). Same
// function: flash attention with an online softmax straight over the paged
// cache, no gathered context tensor in device memory. Query token t of row
// b sees context position c when c <= q_start[b] + t and c < kv_lens[b]; a
// row whose context is all masked outputs 0. q is scaled by D^-0.5
// (qscale, rounded to f32) as it is loaded, one f32 rounding of the
// product, as the JAX wrapper's multiply rounds it; every sum is f32.
//
// A cache policy (FloatCache below, the one this file instantiates) loads
// one element of one context position as f32; its kQuant hooks (a
// per-(block, kv head) K scale on the scores after q.k, a V scale on each
// chunk's p.v, the TPU kernel's order) are set by no policy here.
//
// What bounds it on an H100: the bytes of K/V read (4 bytes an element).
// Each context block a row uses is read once per (row, kv head, tile of
// query rows, split); the arithmetic (two length-D products per visible
// position) is far below the card's FMA rate. The design keeps the reads to
// what the rows need:
//   - one thread block per (row b, kv head, tile of 16 query rows, split);
//     the TPU's sequential grid axis over context blocks becomes a loop
//     inside the block, carrying (m, l, acc) in registers;
//   - the block reads its row's block table itself and stops at
//     ceil(kv_len / BS) blocks and at the tile's last query position, so a
//     ragged batch costs its real context, not B x NBLK blocks;
//   - each [BS, D] K/V tile of its kv head is staged once in shared memory
//     and serves all the tile's query rows (GQA: the rep = H/KH query heads
//     of one kv head are rows t*rep + j of one tile);
//   - split-K (gridDim.y > 1) cuts the block walk into contiguous ranges
//     and writes each range's raw (acc, m, l); a torch combine outside the
//     kernel merges them, as the jnp combine does outside the TPU kernel.
// Plain CUDA cores and FMA; its redesign for the tensor cores is later
// work (ROADMAP Queue 2).
//
// Thread layout: 4 warps x 4 rows per warp = 16 query rows per block (row
// lr = warp + 4 * i). Inside a warp, lane c owns context position c of a
// 32-position chunk for the scores and head-dim elements lane + 32 * j of
// the accumulator for p.V.
//
// Built by dynamo_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (dyn_paged_attention below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// Cache policies: the payload element type, whether the cache carries
// scales, and the load of element d of a context row as f32. `row` points
// at the row's payload for one kv head (Dp = D / kPack elements).
struct FloatCache {
    using Elem = float;
    static constexpr bool kQuant = false;
    static constexpr int kPack = 1;
    __device__ static float load(const Elem* row, int d, int /*half*/) { return row[d]; }
};

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// NCH = ceil(D / 32): head-dim elements each lane accumulates.
template <typename Cache, int NCH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,           // [B, T, H, D]
                       const typename Cache::Elem* __restrict__ k_cache,  // [NB, BS, KH, Dp]
                       const typename Cache::Elem* __restrict__ v_cache,  // [NB, BS, KH, Dp]
                       const float* __restrict__ k_scale,     // [NB, KH] (quantized)
                       const float* __restrict__ v_scale,     // [NB, KH] (quantized)
                       const int32_t* __restrict__ block_tables,  // [B, NBLK]
                       const int32_t* __restrict__ q_start,   // [B]
                       const int32_t* __restrict__ kv_lens,   // [B]
                       float* __restrict__ out,               // [B, T, H, D] (1 split)
                       float* __restrict__ acc_out,           // [B, NS, KH, R, D]
                       float* __restrict__ m_out,             // [B, NS, KH, R]
                       float* __restrict__ l_out,             // [B, NS, KH, R]
                       int n_tok, int H, int KH, int D, int BS, int NBLK,
                       int spb, int n_rtiles, float qscale) {
    extern __shared__ float smem[];
    float* q_s = smem;                         // [16][D]
    float* k_s = q_s + kRowsPerBlock * D;      // [BS][D + 1], padded: lane c reads row c
    float* v_s = k_s + BS * (D + 1);           // [BS][D]

    const int rep = H / KH;
    const int R = n_tok * rep;
    const int rtile = blockIdx.x % n_rtiles;
    const int kh = (blockIdx.x / n_rtiles) % KH;
    const int b = blockIdx.x / (n_rtiles * KH);
    const int split = blockIdx.y;
    const int ns = gridDim.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = rtile * kRowsPerBlock;
    const int qs = q_start[b];
    const int kv_len = kv_lens[b];

    for (int e = threadIdx.x; e < kRowsPerBlock * D; e += kThreads) {
        const int r = row0 + e / D;
        const int d = e % D;
        float val = 0.f;
        if (r < R) {
            const int h = kh * rep + r % rep;
            val = q[(((size_t)b * n_tok + r / rep) * H + h) * D + d] * qscale;
        }
        q_s[e] = val;
    }

    float acc[kRowsPerWarp][NCH];
    float m[kRowsPerWarp];
    float l[kRowsPerWarp];
    int qpos[kRowsPerWarp];  // query position of the row; -1 past the last row
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) acc[i][j] = 0.f;
        m[i] = kNegInf;
        l[i] = 0.f;
        const int r = row0 + warp + kWarps * i;
        qpos[i] = r < R ? qs + r / rep : -1;
    }

    // Blocks this split walks: its contiguous range, cut at the row's last
    // used block (ragged early exit) and at the tile's last query position
    // (blocks past it are masked for every row of the tile).
    const int last_row = min(row0 + kRowsPerBlock, R) - 1;
    const int causal_blocks = (qs + last_row / rep) / BS + 1;
    const int used_blocks = min((kv_len + BS - 1) / BS, NBLK);
    const int g_end = min(min(used_blocks, causal_blocks), (split + 1) * spb);

    const int Dp = D / Cache::kPack;  // payload elements of a row and head
    for (int g = split * spb; g < g_end; ++g) {
        const int blk = block_tables[(size_t)b * NBLK + g];
        const size_t base = (size_t)blk * BS * KH * Dp + (size_t)kh * Dp;
        float ks = 1.f, vs = 1.f;
        if constexpr (Cache::kQuant) {
            ks = k_scale[(size_t)blk * KH + kh];
            vs = v_scale[(size_t)blk * KH + kh];
        }
        __syncthreads();  // the previous tile is consumed (and q_s is staged)
        for (int e = threadIdx.x; e < BS * D; e += kThreads) {
            const int c = e / D;
            const int d = e % D;
            const size_t row = base + (size_t)c * KH * Dp;
            k_s[c * (D + 1) + d] = Cache::load(k_cache + row, d, Dp);
            v_s[c * D + d] = Cache::load(v_cache + row, d, Dp);
        }
        __syncthreads();

        for (int c0 = 0; c0 < BS; c0 += 32) {
            const int c = c0 + lane;
            const bool in_tile = c < BS;
            const int pos = g * BS + c;
            float s[kRowsPerWarp];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
            if (in_tile) {
                const float* krow = k_s + c * (D + 1);
                for (int d = 0; d < D; ++d) {
                    const float kv = krow[d];
#pragma unroll
                    for (int i = 0; i < kRowsPerWarp; ++i)
                        s[i] = fmaf(q_s[(warp + kWarps * i) * D + d], kv, s[i]);
                }
            }
            const int nc = min(32, BS - c0);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
                const bool vis = in_tile && pos <= qpos[i] && pos < kv_len;
                const float sc = vis ? s[i] * ks : kNegInf;  // ks == 1: float cache
                const float m_new = fmaxf(m[i], warp_max(sc));
                const float alpha = expf(m[i] - m_new);
                const float p = vis ? expf(sc - m_new) : 0.f;
                l[i] = alpha * l[i] + warp_sum(p);
                if constexpr (Cache::kQuant) {
                    // p.v over the chunk's int values, then times the
                    // block's V scale (the TPU kernel's order)
                    float pv[NCH];
#pragma unroll
                    for (int j = 0; j < NCH; ++j) pv[j] = 0.f;
                    for (int cc = 0; cc < nc; ++cc) {
                        const float pc = __shfl_sync(kFull, p, cc);
                        const float* vrow = v_s + (c0 + cc) * D;
#pragma unroll
                        for (int j = 0; j < NCH; ++j) {
                            const int d = lane + 32 * j;
                            if (d < D) pv[j] = fmaf(pc, vrow[d], pv[j]);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < NCH; ++j) acc[i][j] = fmaf(acc[i][j], alpha, pv[j] * vs);
                } else {
#pragma unroll
                    for (int j = 0; j < NCH; ++j) acc[i][j] *= alpha;
                    for (int cc = 0; cc < nc; ++cc) {
                        const float pc = __shfl_sync(kFull, p, cc);
                        const float* vrow = v_s + (c0 + cc) * D;
#pragma unroll
                        for (int j = 0; j < NCH; ++j) {
                            const int d = lane + 32 * j;
                            if (d < D) acc[i][j] = fmaf(pc, vrow[d], acc[i][j]);
                        }
                    }
                }
                m[i] = m_new;
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = row0 + warp + kWarps * i;
        if (r >= R) continue;
        if (ns == 1) {
            const float denom = l[i] == 0.f ? 1.f : l[i];  // all-masked rows -> 0
            const int h = kh * rep + r % rep;
            float* o = out + (((size_t)b * n_tok + r / rep) * H + h) * D;
#pragma unroll
            for (int j = 0; j < NCH; ++j) {
                const int d = lane + 32 * j;
                if (d < D) o[d] = acc[i][j] / denom;
            }
        } else {
            const size_t srow = (((size_t)b * ns + split) * KH + kh) * R + r;
#pragma unroll
            for (int j = 0; j < NCH; ++j) {
                const int d = lane + 32 * j;
                if (d < D) acc_out[srow * D + d] = acc[i][j];
            }
            if (lane == 0) {
                m_out[srow] = m[i];
                l_out[srow] = l[i];
            }
        }
    }
}

template <typename Cache, int NCH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int32_t* bt, const int32_t* qs, const int32_t* kl, void* out, float* acc,
           float* m, float* l, int B, int n_tok, int H, int KH, int D, int BS, int NBLK,
           int ns, int spb, float qscale, cudaStream_t stream) {
    using Elem = typename Cache::Elem;
    const int R = n_tok * (H / KH);
    const int n_rtiles = (R + kRowsPerBlock - 1) / kRowsPerBlock;
    const size_t smem = sizeof(float) * ((size_t)kRowsPerBlock * D
                                         + (size_t)BS * (D + 1) + (size_t)BS * D);
    auto kernel = paged_attention_kernel<Cache, NCH>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((unsigned)(B * KH * n_rtiles), (unsigned)ns);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const Elem*>(k), static_cast<const Elem*>(v),
        ks, vs, bt, qs, kl, static_cast<float*>(out), acc, m, l, n_tok, H, KH, D, BS, NBLK,
        spb, n_rtiles, qscale);
    return (int)cudaGetLastError();
}

template <typename Cache>
int dispatch_nch(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int32_t* bt, const int32_t* qs, const int32_t* kl,
                 void* out, float* acc, float* m, float* l, int B, int n_tok, int H,
                 int KH, int D, int BS, int NBLK, int ns, int spb, float qscale,
                 cudaStream_t stream) {
    const int nch = (D + 31) / 32;
#define DYN_PA_LAUNCH(N)                                                              \
    return launch<Cache, N>(q, k, v, ks, vs, bt, qs, kl, out, acc, m, l, B, n_tok, H, \
                            KH, D, BS, NBLK, ns, spb, qscale, stream)
    if (nch <= 1) DYN_PA_LAUNCH(1);
    if (nch <= 2) DYN_PA_LAUNCH(2);
    if (nch <= 4) DYN_PA_LAUNCH(4);
    DYN_PA_LAUNCH(8);
#undef DYN_PA_LAUNCH
}

int dispatch_cache(int cache_kind, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int32_t* bt, const int32_t* qs,
                   const int32_t* kl, void* out, float* acc, float* m, float* l, int B,
                   int n_tok, int H, int KH, int D, int BS, int NBLK, int ns, int spb,
                   float qscale, cudaStream_t stream) {
#define DYN_PA_CACHE(C)                                                                 \
    return dispatch_nch<C>(q, k, v, ks, vs, bt, qs, kl, out, acc, m, l, B, n_tok, H, KH, \
                           D, BS, NBLK, ns, spb, qscale, stream)
    if (cache_kind == 0) DYN_PA_CACHE(FloatCache);
#undef DYN_PA_CACHE
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 q and out, the only q this design takes (1 =
// bfloat16 returns cudaErrorInvalidValue). q is unscaled: the kernel
// multiplies it by qscale = D^-0.5 rounded to f32. cache_kind: 0 = model
// precision (an f32 cache, scales unused), the only cache it takes (1 =
// int8 and 2 = packed int4 are dyn_paged_attention_mma's with f32 q, and
// return cudaErrorInvalidValue here).
// ns == 1 writes normalised rows to `out`; ns > 1 writes each split's raw
// (acc, m, l) and leaves `out` alone. Returns cudaGetLastError() of the
// launch (0 = launched).
int dyn_paged_attention(int dtype, int cache_kind, const void* q, const void* k_cache,
                        const void* v_cache, const float* k_scale, const float* v_scale,
                        const int32_t* block_tables, const int32_t* q_start,
                        const int32_t* kv_lens, void* out, float* acc, float* m, float* l,
                        int B, int n_tok, int H, int KH, int D, int BS, int NBLK, int ns,
                        int spb, float qscale, void* stream) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    return dispatch_cache(cache_kind, q, k_cache, v_cache, k_scale, v_scale, block_tables,
                          q_start, kv_lens, out, acc, m, l, B, n_tok, H, KH, D, BS, NBLK, ns,
                          spb, qscale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
