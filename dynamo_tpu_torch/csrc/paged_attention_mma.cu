// Paged attention on Hopper's tensor cores (sm_90a): bf16 queries over a
// bf16, an int8 or a packed-int4 KV cache, and f32 queries over an f32, an
// int8 or a packed-int4 cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/paged_attention.py
// (paged_attention_kernel :314, body _kernel :199) for every route:
//
//   TPU kernel variant (:314)             | route here (q dtype, cache) | cache policy, query policy
//   model-precision cache                 | bf16 q, bf16 cache          | Bf16Cache, QueryBf16
//   model-precision cache, f32 (f32       | f32 q, f32 cache            | F32Cache, QueryF32
//     products :255-257, :272-274)        |                             |
//   int8 cache (quant :201-206, :258-276) | bf16 q, int8 cache          | Int8Cache, QueryBf16
//   packed-int4 cache (int4 :240-251)     | bf16 q, int4 cache          | Int4Cache, QueryBf16
//   int8 cache with f32 q (f32 products   | f32 q, int8 cache           | Int8Cache, QueryF32
//     :256, :273)                         |                             |
//   packed-int4 cache with f32 q          | f32 q, int4 cache           | Int4Cache, QueryF32
//
// Same function as the TPU kernel: flash attention
// with an online softmax straight over the paged cache. Query token t of
// row b sees context position c when c <= q_start[b] + t and c < kv_lens[b];
// a row whose context is all masked outputs 0; for a quantized cache the
// block's f32 K scale multiplies the scores after q.k and its V scale the
// block's p.v before it joins the accumulator; split-K (gridDim.y > 1)
// writes each split's raw f32 (acc, m, l) for the torch combine. q is
// scaled by D^-0.5 in q's dtype as it is loaded (the TPU wrapper's
// rounding), and the output has q's dtype.
// Payloads: bf16 [NB, BS, KH, D]; f32 [NB, BS, KH, D]; int8 [NB, BS, KH,
// D]; int4 uint8 [NB, BS, KH, D/2], byte j holding element j (low nibble)
// and j + D/2 (high), sign-extended.
//
// f32 q keeps the TPU kernel's f32 products on bf16 tensor cores. An int8
// or int4 value is exact in bf16, and an f32 x splits exactly into three
// bf16 terms: hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid) (8 + 8 + 8
// bits of significand for f32's 24; each subtraction is exact in f32). So
// q.k = q_hi.k + q_mid.k + q_lo.k and p.v = p_hi.v + p_mid.v + p_lo.v, three
// MMAs each, every partial product exact in f32 (8-bit x 8-bit
// significands) and summed in f32 by the tensor core: the f32 products up
// to the order of the f32 sums. An f32 cache element is split the same
// way, and of the nine term products the three below 2^-24 of the whole
// (mid.lo, lo.mid, lo.lo: |mid| <= 2^-8 |x|, |lo| <= 2^-16 |x|) are
// dropped: six MMAs for q.k and six for p.v. A query policy (QueryBf16,
// QueryF32 below) holds what differs on q's side: bf16 q is one term and p
// two (p_hi + p_lo, ~16 bits, enough for a bf16 output), f32 q three of
// each.
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its context
// once at 4 bytes (f32), 2 bytes (bf16), 1 byte (int8) or half a byte
// (int4) an element, plus 8 bytes of scales per block for a quantized
// cache; the two products do ~1-4 operations per byte read (three or six
// times as many MMAs for f32 q), far below the ~295 per byte at which the
// tensor cores would be the limit. So the design keeps many loads in
// flight and little work per byte:
//   - loads: the context is walked in units of 16 positions (a block is
//     BS/16 units). A unit's K and V rows are copied with 16-byte cp.async
//     (8-byte where a quantized head's row is not a multiple of 16 bytes),
//     and a quantized unit's two f32 scales with 4-byte ones, into a ring
//     of kStages items in shared memory: the next kStages-1 items are in
//     flight while one is consumed. An item is a whole unit, or for the
//     f32 cache (kSplitKV) its K rows or its V rows: a ring of three such
//     items keeps a unit in flight in 3/4 of the bytes of two whole units,
//     which at D = 128 leaves room for 2 CTAs an SM at decode (4 rings of
//     25,344 B + 8 KB of q terms = 109,568 B a CTA) and lets D = 256
//     launch (216,064 B a CTA, 1 CTA an SM). Block-table entries are read
//     32 at a time, one per lane;
//   - operands: a cache policy (Bf16Cache, F32Cache, Int8Cache, Int4Cache
//     below) turns staged bytes into the MMA's bf16 B fragments. bf16 rows
//     already are the operands: ldmatrix.x4 reads K as q.k's col-major B
//     and ldmatrix.x4.trans reads V as p.v's. f32 rows are read 16 bytes a
//     thread and split into three terms in registers, as each fragment is
//     built. int8 / int4 are widened in registers, once per element: int8
//     through an exact f32 magic-number widening (|x| <= 127 fits bf16's
//     significand, so the f32's upper half is the bf16); int4 by placing
//     the biased nibble in a bf16 mantissa and subtracting the bias, both
//     nibbles of a byte from one load;
//   - both products on tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate): S = Q.K^T with a warp's 16 query rows on M and the
//     unit's 16 positions on N; S's accumulator fragments are P's A
//     fragments for O += P.V, a unit being one k-step. q's first term sits
//     in registers for the whole walk; f32 q's mid and lo terms are staged
//     once a row group in shared memory, in fragment order (one 16-byte
//     load a lane and k-step), and shared by the row group's walkers, so a
//     thread need hold no more of q than for bf16 q;
//   - parallelism: one CTA of 4 warps per (row, kv head, tile of query
//     rows, split). Decode (R = T * H/KH <= 16 rows) puts all 4 warps on
//     the same 16 rows, each walking every 4th unit through its own ring;
//     R <= 32 puts 2 row groups of 16 in a CTA with 2 warps each, larger R
//     4 row groups of one warp. There a quantized policy keeps one ring a
//     warp, while the bf16 and f32 policies stage each unit once for the
//     whole CTA (one ring the CTA's warps fill together, a CTA barrier
//     before a stage is refilled) and every row group reads it.
//     The walkers of a row group merge their (acc, m, l) in shared memory
//     at the end with the logsumexp merge; a warp alone on its row group
//     writes from its registers. The wrapper (ops/paged_attention.py,
//     mma_row_groups) picks the row groups.
// Fragment layout of the quantized and f32 policies: each index of a
// product's contraction may be permuted as long as both operands agree, so
// each thread reads contiguous bytes of a row: K bytes [tig*D/4, +D/4)
// (int8) or [tig*D/8, +D/8) (int4) of positions gid and gid+8; V bytes
// [gid*D/8, +D/8) or [gid*D/16, +D/16) of positions 2tig, 2tig+1, 2tig+8,
// 2tig+9; f32 one 16-byte chunk of a row a read (F32Cache::k_chunk,
// dmap), chosen so that the 8 lanes of a read phase hit 8 distinct bank
// groups. q's A fragments follow K's choice (q_elem), the output columns
// V's (dmap). The bf16 policy keeps the MMA's own layout (dmap is the
// identity).
//
// Shapes: D a multiple of 16 up to 256, BS a multiple of 16 (the wrapper
// refuses others). Built by dynamo_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (dyn_paged_attention_mma below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 16;       // context positions a unit (one MMA tile)
constexpr int kRows = 16;       // query rows a warp holds (the MMA's M)
constexpr int kPad = 16;        // bytes of padding after each staged row
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// Units in a ring of the bf16 policy: 2 and 3 time alike at D = 16, 64 and
// 128 on an NVIDIA H100 80GB HBM3 (700 W), 4 costs a CTA an SM at decode
// (PERF.md, the bf16 stage count), so the smaller ring, at every D.
constexpr int kBf16Stages = 2;

constexpr int pow2_align(int x) {
    return x % 16 == 0 ? 16 : x % 8 == 0 ? 8 : x % 4 == 0 ? 4 : x % 2 == 0 ? 2 : 1;
}
constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane L gives the address of
// row L%8 of matrix L/8. Thread t gets, of matrix i, row t/4, columns
// 2(t%4), 2(t%4)+1 (ldsm_x4) or rows 2(t%4), 2(t%4)+1, column t/4
// (ldsm_x4_trans), the lower index in the lower half.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a.b: m16n8k16, a row-major bf16 (4 regs), b col-major bf16 (2 regs)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
    return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// N bytes at p (address aligned to A) into words, byte i at bits 8*(i%4)
// of word i/4, with the widest loads the alignment allows.
template <int N, int A>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[(N + 3) / 4], const uint8_t* p) {
    if constexpr (N % 16 == 0 && A % 16 == 0) {
#pragma unroll
        for (int i = 0; i < N / 16; ++i) {
            const uint4 v = reinterpret_cast<const uint4*>(p)[i];
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
        }
    } else if constexpr (N % 8 == 0 && A % 8 == 0) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
            const uint2 v = reinterpret_cast<const uint2*>(p)[i];
            w[2 * i] = v.x;
            w[2 * i + 1] = v.y;
        }
    } else if constexpr (N % 4 == 0 && A % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    } else if constexpr (N % 2 == 0 && A % 2 == 0) {
#pragma unroll
        for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0;
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            w[i / 2] |= uint32_t(reinterpret_cast<const uint16_t*>(p)[i]) << (16 * (i % 2));
    } else {
#pragma unroll
        for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) w[i / 4] |= uint32_t(p[i]) << (8 * (i % 4));
    }
}

template <int W>
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[W], int i) {
    return (w[i >> 2] >> ((i & 3) * 8)) & 0xFFu;
}

// f32 bits of the int8 held in byte i of x, where x is the payload word
// XOR 0x80808080 (the byte is x + 128): 2^23 + (x + 128) - (2^23 + 128),
// exact.
__device__ __forceinline__ uint32_t i8_f32(uint32_t x, int i) {
    const uint32_t u = __byte_perm(x, 0x4B000000u, 0x7440u | i);
    return __float_as_uint(__uint_as_float(u) - 8388736.0f);
}

// bf16x2 of two f32s that bf16 holds exactly (their upper halves).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
    return __byte_perm(lo, hi, 0x7632u);
}

// bf16x2 of two signed nibbles (the low 4 bits of n0, n1): 128 + (n ^ 8)
// in a bf16 mantissa, minus 136, exact.
__device__ __forceinline__ uint32_t nib_pair(uint32_t n0, uint32_t n1) {
    const uint32_t v = ((n0 & 0xFu) | ((n1 & 0xFu) << 16)) ^ 0x43084308u;
    return as_u32(__hsub2(as_bf162(v), as_bf162(0x43084308u)));
}

// x = t[0] + t[1] + ... for the pair (a, b), each term bf16x2: t[i] is
// what is left after the earlier terms, rounded to nearest even. Two terms
// keep ~16 bits of an f32; three keep all 24 (each remainder is exact in
// f32, and the third fits bf16's 8-bit significand).
template <int NT>
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t (&t)[NT]) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(h);
        t[i] = as_u32(h);
        a -= hf.x;
        b -= hf.y;
    }
}

// q * D^-0.5 rounded to bf16, as the wrapper's torch multiply rounds it
// (the bf16 x bf16 product is exact in f32, then one rounding)
__device__ __forceinline__ uint32_t scale_pair(uint32_t u, float s) {
    const float2 f = __bfloat1622float2(as_bf162(u));
    return as_u32(__floats2bfloat162_rn(f.x * s, f.y * s));
}

// ---------------------------------------------------------------------------
// Query policies: q's (and the output's) element type, the bf16 terms q
// enters q.k as (kQTerms) and p enters p.v as (kPTerms), and the load of
// q's A-fragment words times qscale, word j of a k-step holding q elements
// e_j, e_j + 1. bf16 q (one term) loads a k-step's two words together and,
// where they are adjacent (kAdjacent: e1 = e0 + 2, e0 a multiple of 4),
// with one 8-byte load; f32 q loads a word's two elements at a time, one
// 8-byte load a word. Both were chosen by paired timing on an H100 (PERF.md
// §6): two 4-byte loads cost the int8 bf16-q kernel ~3% at decode, and
// other f32 load loops led nvcc to give the int8 D=128 kernel 168
// registers instead of 254 and run 4-14% slower.
// ---------------------------------------------------------------------------

struct QueryBf16 {
    using T = __nv_bfloat16;
    static constexpr int kQTerms = 1;  // q scaled in bf16 is a bf16
    static constexpr int kPTerms = 2;  // p_hi + p_lo: ~16 bits of p
    template <bool kAdjacent>
    __device__ static void load_kstep(uint32_t (&w)[2], const T* row, int e0, int e1, float qs) {
        if constexpr (kAdjacent) {
            const uint2 v = *reinterpret_cast<const uint2*>(row + e0);
            w[0] = scale_pair(v.x, qs);
            w[1] = scale_pair(v.y, qs);
        } else {
            w[0] = scale_pair(*reinterpret_cast<const uint32_t*>(row + e0), qs);
            w[1] = scale_pair(*reinterpret_cast<const uint32_t*>(row + e1), qs);
        }
    }
    __device__ static T to_out(float x) { return __float2bfloat16(x); }
};

// f32 q: one f32 multiply by qscale (the wrapper's rounding; __fmul_rn, so
// the split's first subtraction is not contracted into an FMA with the
// unrounded product), then the exact three-term split; p is split the same
// way
struct QueryF32 {
    using T = float;
    static constexpr int kQTerms = 3;
    static constexpr int kPTerms = 3;
    __device__ static void load_pair(uint32_t (&t)[kQTerms], const T* row, int e, float qs) {
        const float2 v = *reinterpret_cast<const float2*>(row + e);
        split_bf16<kQTerms>(__fmul_rn(v.x, qs), __fmul_rn(v.y, qs), t);
    }
    __device__ static T to_out(float x) { return x; }
};

// c += a.b with a's four words read from shared memory in one load (a
// staged term of q, see the kernel's q stage)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4* a, uint32_t b0, uint32_t b1) {
    const uint4 w = *a;
    const uint32_t r[4] = {w.x, w.y, w.z, w.w};
    mma_bf16(c, r, b0, b1);
}

// acc[j] = acc[j] * alpha + pv * vs for one n-tile of p.v
__device__ __forceinline__ void accumulate(float (&acc)[4], const float (&pv)[4],
                                           const float (&alpha)[2], float vs) {
    acc[0] = fmaf(acc[0], alpha[0], pv[0] * vs);
    acc[1] = fmaf(acc[1], alpha[0], pv[1] * vs);
    acc[2] = fmaf(acc[2], alpha[1], pv[2] * vs);
    acc[3] = fmaf(acc[3], alpha[1], pv[3] * vs);
}

// ---------------------------------------------------------------------------
// Cache policies. Each gives a ring item's byte geometry (K rows, V rows,
// and for a quantized cache the block's two f32 scales; with kSplitKV an
// item holds a unit's K rows or its V rows), the q A-fragment layout its K
// fragments agree with, S = Q.K^T and O += P.V over one staged unit, the
// head-dim element of each output column (dmap) and a merge-area layout
// free of bank conflicts.
// ---------------------------------------------------------------------------

// int8 (kInt4 false) or packed int4 (true): widened in registers.
template <bool kInt4, int D_>
struct QuantCache {
    static constexpr int D = D_;
    static constexpr bool kScaled = true;
    static constexpr bool kSharedStage = false;
    static constexpr bool kSplitKV = false;
    static constexpr int kMinBlocks = 0;  // no minimum asked of ptxas (see F32Cache)
    static constexpr int kStages = 3;
    static constexpr int Dp = kInt4 ? D / 2 : D;         // payload bytes of a row
    static constexpr int SP = Dp + kPad;                  // staged row stride
    static constexpr int CB = Dp % 16 == 0 ? 16 : 8;      // cp.async bytes
    static constexpr int CPR = Dp / CB;                   // copies a row
    static constexpr int STAGE = 2 * kUnit * SP + 16;     // K rows, V rows, 2 scales
    static constexpr int KCH = kInt4 ? D / 8 : D / 4;     // K bytes a thread reads a row
    static constexpr int VCH = kInt4 ? D / 16 : D / 8;    // V bytes a thread reads a row
    static constexpr int NK = D / 16;                     // k-steps of q.k
    static constexpr int NN = D / 8;                      // n-tiles of p.v
    static constexpr int KW = (KCH + 3) / 4;
    static constexpr int VW = (VCH + 3) / 4;
    static constexpr int KALIGN = cmin(pow2_align(SP), pow2_align(KCH));
    static constexpr int VALIGN = cmin(pow2_align(SP), pow2_align(VCH));
    // merge area: element d of a row sits d / (2 VCH) words past d, and a
    // row takes MS words, MS / 4 odd, so a warp's store of one accumulator
    // register (rows gid, columns 2tig + e) hits 32 banks
    static constexpr int MS0 = D + D / (2 * VCH);
    static constexpr int MS = MS0 % 8 == 0 ? MS0 + 4 : MS0;
    // q_elem(kk, tig, 1) = q_elem(kk, tig, 0) + 2, a multiple of 4 (int8)
    static constexpr bool kQAdjacent = !kInt4;

    __device__ static int merge_idx(int row, int d) { return row * MS + d + d / (2 * VCH); }

    // The head-dim element held in column n of p.v's n-tile j (the inverse
    // of the V fragment's byte choice below).
    __device__ static int dmap(int j, int n) {
        if constexpr (kInt4)
            return j < VCH ? n * VCH + j : D / 2 + n * VCH + (j - VCH);
        else
            return n * VCH + j;
    }

    // The q element in the first half of A-fragment word j of k-step kk
    // (j = 0: contraction index 2tig, 2tig+1; j = 1: 2tig+8, 2tig+9), as the
    // K byte choice below pairs them
    __device__ static int q_elem(int kk, int tig, int j) {
        if constexpr (kInt4)
            return (j ? D / 2 : 0) + tig * KCH + 2 * kk;
        else
            return tig * KCH + 4 * kk + 2 * j;
    }

    // S = Q.K^T over the staged K rows: n-tile n holds positions 8n + gid.
    // q's first term is qa; with f32 q (QT = 3) term t of k-step kk is read
    // from the stage at qx[((t - 1) * NK + kk) * 32]
    template <int QT>
    __device__ static void scores(float (&s)[2][4], const uint32_t (&qa)[NK][4],
                                  const uint4* qx, const uint8_t* kst, int lane) {
        const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            uint32_t kw[KW];
            load_bytes<KCH, KALIGN>(kw, kst + (gid + 8 * n) * SP + tig * KCH);
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
                uint32_t b0, b1;
                if constexpr (kInt4) {
                    const uint32_t x0 = byte_of(kw, 2 * kk);
                    const uint32_t x1 = byte_of(kw, 2 * kk + 1);
                    b0 = nib_pair(x0, x1);
                    b1 = nib_pair(x0 >> 4, x1 >> 4);
                } else {
                    const uint32_t x = kw[kk] ^ 0x80808080u;
                    b0 = bf16_pair(i8_f32(x, 0), i8_f32(x, 1));
                    b1 = bf16_pair(i8_f32(x, 2), i8_f32(x, 3));
                }
                mma_bf16(s[n], qa[kk], b0, b1);
#pragma unroll
                for (int t = 1; t < QT; ++t) mma_bf16(s[n], qx + ((t - 1) * NK + kk) * 32, b0, b1);
            }
        }
    }

    // O = O * alpha + (P.V) * vs over the staged V rows, n-tile j by n-tile
    // j; P enters as the sum of its PT bf16 terms
    template <int PT>
    __device__ static void pv(float (&acc)[NN][4], const uint32_t (&p)[PT][4],
                              const uint8_t* vst, int lane, const float (&alpha)[2], float vs) {
        const int gid = lane >> 2, tig = lane & 3;
        uint32_t vw[4][VW];  // positions 2tig, 2tig+1, 2tig+8, 2tig+9
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
            const int row = 2 * tig + (i4 & 1) + 8 * (i4 >> 1);
            load_bytes<VCH, VALIGN>(vw[i4], vst + row * SP + gid * VCH);
            if constexpr (!kInt4) {
#pragma unroll
                for (int w = 0; w < VW; ++w) vw[i4][w] ^= 0x80808080u;
            }
        }
#pragma unroll
        for (int j = 0; j < NN; ++j) {
            uint32_t b0, b1;
            if constexpr (kInt4) {
                const int jj = j < VCH ? j : j - VCH;
                const int sh = j < VCH ? 0 : 4;
                b0 = nib_pair(byte_of(vw[0], jj) >> sh, byte_of(vw[1], jj) >> sh);
                b1 = nib_pair(byte_of(vw[2], jj) >> sh, byte_of(vw[3], jj) >> sh);
            } else {
                b0 = bf16_pair(i8_f32(vw[0][j >> 2], j & 3), i8_f32(vw[1][j >> 2], j & 3));
                b1 = bf16_pair(i8_f32(vw[2][j >> 2], j & 3), i8_f32(vw[3][j >> 2], j & 3));
            }
            float pvj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int t = 0; t < PT; ++t) mma_bf16(pvj, p[t], b0, b1);
            accumulate(acc[j], pvj, alpha, vs);
        }
    }
};

template <int D>
using Int8Cache = QuantCache<false, D>;
template <int D>
using Int4Cache = QuantCache<true, D>;

// bf16: staged rows are the MMA's operands, read with ldmatrix.
template <int D_>
struct Bf16Cache {
    static constexpr int D = D_;
    static constexpr bool kScaled = false;
    static constexpr bool kSharedStage = true;
    static constexpr bool kSplitKV = false;
    static constexpr int kMinBlocks = 0;  // no minimum asked of ptxas (see F32Cache)
    static constexpr int kStages = kBf16Stages;
    static constexpr int Dp = 2 * D;             // payload bytes of a row
    // staged row stride: SP / 16 is odd, so the 8 rows of one ldmatrix
    // matrix fall in 8 distinct 16-byte bank groups
    static constexpr int SP = Dp + kPad;
    static constexpr int CB = 16;                // cp.async bytes (Dp is a multiple of 32)
    static constexpr int CPR = Dp / CB;
    static constexpr int STAGE = 2 * kUnit * SP;  // K rows, V rows
    static constexpr int NK = D / 16;
    static constexpr int NN = D / 8;
    // merge area: MS = 8 (mod 32) words a row and rows 4-7 of each 8 one
    // word later, so a warp's store of one accumulator register (rows gid,
    // columns 2tig + e) hits 32 banks
    static constexpr int MS = D + (D % 32 == 0 ? 8 : 24);
    static constexpr bool kQAdjacent = false;

    __device__ static int merge_idx(int row, int d) { return row * MS + d + ((row >> 2) & 1); }
    __device__ static int dmap(int j, int n) { return 8 * j + n; }

    __device__ static int q_elem(int kk, int tig, int j) { return 16 * kk + 8 * j + 2 * tig; }

    // One ldmatrix.x4 a k-step: matrices (positions 0-7 | 8-15) x (dims
    // 16kk.. | 16kk+8..), the B fragments of both n-tiles. bf16 q only.
    template <int QT>
    __device__ static void scores(float (&s)[2][4], const uint32_t (&qa)[NK][4],
                                  const uint4* /*qx*/, const uint8_t* kst, int lane) {
        static_assert(QT == 1, "a bf16 cache takes bf16 q only");
        const int mi = lane >> 3;
        const uint8_t* row = kst + ((lane & 7) + 8 * (mi >> 1)) * SP + 16 * (mi & 1);
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, row + 32 * kk);
            mma_bf16(s[0], qa[kk], b[0], b[1]);
            mma_bf16(s[1], qa[kk], b[2], b[3]);
        }
    }

    // One ldmatrix.x4.trans a pair of n-tiles: matrices (positions 0-7 |
    // 8-15) x (dims 8j.. | 8j+8..), V^T's B fragments of n-tiles j, j+1.
    template <int PT>
    __device__ static void pv(float (&acc)[NN][4], const uint32_t (&p)[PT][4],
                              const uint8_t* vst, int lane, const float (&alpha)[2], float vs) {
        const int mi = lane >> 3;
        const uint8_t* row = vst + ((lane & 7) + 8 * (mi & 1)) * SP + 16 * (mi >> 1);
#pragma unroll
        for (int j = 0; j < NN; j += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, row + 16 * j);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                float pvj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int i = 0; i < PT; ++i) mma_bf16(pvj, p[i], b[2 * t], b[2 * t + 1]);
                accumulate(acc[j + t], pvj, alpha, vs);
            }
        }
    }
};

__device__ __forceinline__ float elem(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// c += the six products of a's and b's three bf16 terms (a[t], (b0[t],
// b1[t])) larger than 2^-24 of the whole, smallest first: mid.mid, hi.lo,
// lo.hi (~2^-16 of the whole), hi.mid, mid.hi, hi.hi (the f32-limit
// errors of phase (a) read the same as with the largest first, PERF.md §6)
__device__ __forceinline__ void mma6(float (&c)[4], const uint32_t (&a0)[4],
                                     const uint32_t (&a1)[4], const uint32_t (&a2)[4],
                                     const uint32_t (&b0)[3], const uint32_t (&b1)[3]) {
    mma_bf16(c, a1, b0[1], b1[1]);
    mma_bf16(c, a0, b0[2], b1[2]);
    mma_bf16(c, a2, b0[0], b1[0]);
    mma_bf16(c, a0, b0[1], b1[1]);
    mma_bf16(c, a1, b0[0], b1[0]);
    mma_bf16(c, a0, b0[0], b1[0]);
}

// f32: staged rows are f32, split in registers into three exact bf16 terms
// as each B fragment is built; f32 q only. A unit's K rows and its V rows
// are ring items of their own (kSplitKV), three a ring.
template <int D_>
struct F32Cache {
    static constexpr int D = D_;
    static constexpr bool kScaled = false;
    static constexpr bool kSharedStage = true;
    static constexpr bool kSplitKV = true;
    // CTAs an SM the launch bounds ask of ptxas (0: none, the other
    // policies' choice, which keeps their code as it was): asked for 2, it
    // gives this policy up to 255 registers; left to itself it gave it 168
    // at D = 128 and spilled, 5-20% slower outside prefill (PERF.md §6)
    static constexpr int kMinBlocks = 2;
    static constexpr int kStages = 3;             // ring items: K and V of a unit, the next K
    static constexpr int Dp = 4 * D;              // payload bytes of a row
    // staged row stride: SP / 16 = D/4 + 1 is odd, so the reads below put
    // the 8 lanes of a 16-byte read phase in 8 distinct bank groups
    static constexpr int SP = Dp + kPad;
    static constexpr int CB = 16;                 // cp.async bytes
    static constexpr int CPR = Dp / CB;
    static constexpr int STAGE = kUnit * SP;      // one item: a unit's K rows or V rows
    static constexpr int NK = D / 16;
    static constexpr int NN = D / 8;
    static constexpr int NG = NN / 4;             // n-tiles read 4 at a time (the rest 2)
    // merge area: MS = 1 (mod 8) words a row, so a warp's store of one
    // accumulator register (rows gid, columns 8tig apart) hits 32 banks
    static constexpr int MS = D + 1;
    static constexpr bool kQAdjacent = false;

    __device__ static int merge_idx(int row, int d) { return row * MS + d; }

    // The 16-byte chunk of a K row that thread tig reads for k-step kk:
    // k-steps 2p and 2p+1 take chunks 8p + 2tig and 8p + 2tig + 1, so the
    // two rows of a read phase (gid 0, 1: SP/16 odd apart) fall on even and
    // odd bank groups; an odd last k-step takes its 4 chunks in order
    __device__ static int k_chunk(int kk, int tig) {
        return kk < (NK & ~1) ? 8 * (kk >> 1) + 2 * tig + (kk & 1) : 4 * kk + tig;
    }

    // The q element in the first half of A-fragment word j of k-step kk:
    // the chunk's elements 0, 1 (j = 0) and 2, 3 (j = 1)
    __device__ static int q_elem(int kk, int tig, int j) { return 4 * k_chunk(kk, tig) + 2 * j; }

    // The head-dim element held in column n of p.v's n-tile j: thread gid
    // reads chunk 8g + gid of a V row for n-tiles 4g..4g+3 (the 4 rows of a
    // read phase 2 positions apart, SP/16 odd: distinct bank groups), and 8
    // bytes at element 32 NG + 2 gid for a last pair of n-tiles
    __device__ static int dmap(int j, int n) {
        return j < 4 * NG ? 32 * (j >> 2) + 4 * n + (j & 3) : 32 * NG + 2 * n + (j - 4 * NG);
    }

    // S = Q.K^T over the staged K rows: n-tile n holds positions 8n + gid.
    // q's hi term is qa, mid and lo are read from the stage at qx[kk * 32]
    // and qx[(NK + kk) * 32]; K's three terms come from one 16-byte read a
    // k-step and n-tile. The products with q_hi go to s, those with q_mid
    // and q_lo (~2^-8 of them) to a second accumulator added at the end,
    // whose sums then round at their own scale (one accumulator read a
    // worst err / f32 limit of 0.104 at prefill against 0.082, PERF.md §6)
    template <int QT>
    __device__ static void scores(float (&s)[2][4], const uint32_t (&qa)[NK][4],
                                  const uint4* qx, const uint8_t* kst, int lane) {
        static_assert(QT == 3, "an f32 cache takes f32 q only");
        const int gid = lane >> 2, tig = lane & 3;
        float s2[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
            const uint4 m4 = qx[kk * 32], l4 = qx[(NK + kk) * 32];
            const uint32_t qm[4] = {m4.x, m4.y, m4.z, m4.w};
            const uint32_t ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const float4 k = *reinterpret_cast<const float4*>(
                    kst + (gid + 8 * n) * SP + 16 * k_chunk(kk, tig));
                uint32_t b0[3], b1[3];
                split_bf16<3>(k.x, k.y, b0);
                split_bf16<3>(k.z, k.w, b1);
                mma_bf16(s2[n], qm, b0[1], b1[1]);     // mid.mid
                mma_bf16(s2[n], ql, b0[0], b1[0]);     // lo.hi
                mma_bf16(s2[n], qm, b0[0], b1[0]);     // mid.hi
                mma_bf16(s[n], qa[kk], b0[2], b1[2]);  // hi.lo
                mma_bf16(s[n], qa[kk], b0[1], b1[1]);  // hi.mid
                mma_bf16(s[n], qa[kk], b0[0], b1[0]);  // hi.hi
            }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
    }

    // O = O * alpha + P.V over the staged V rows, n-tile by n-tile: V
    // elements dmap(j, gid) of positions 2tig, 2tig+1, 2tig+8, 2tig+9, each
    // split into three terms, six MMAs with p's three
    template <int PT>
    __device__ static void pv(float (&acc)[NN][4], const uint32_t (&p)[PT][4],
                              const uint8_t* vst, int lane, const float (&alpha)[2], float vs) {
        static_assert(PT == 3, "an f32 cache takes f32 q only");
        const int gid = lane >> 2, tig = lane & 3;
        const uint8_t* rows[4];  // positions 2tig, 2tig+1, 2tig+8, 2tig+9
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) rows[i4] = vst + (2 * tig + (i4 & 1) + 8 * (i4 >> 1)) * SP;
        auto tile = [&](float (&a)[4], float v0, float v1, float v2, float v3) {
            uint32_t b0[3], b1[3];
            split_bf16<3>(v0, v1, b0);
            split_bf16<3>(v2, v3, b1);
            float pvj[4] = {0.f, 0.f, 0.f, 0.f};
            mma6(pvj, p[0], p[1], p[2], b0, b1);
            accumulate(a, pvj, alpha, vs);
        };
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            float4 v[4];
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
                v[i4] = *reinterpret_cast<const float4*>(rows[i4] + 16 * (8 * g + gid));
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tile(acc[4 * g + e], elem(v[0], e), elem(v[1], e), elem(v[2], e), elem(v[3], e));
        }
        if constexpr (NN % 4 != 0) {
            float2 v[4];
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
                v[i4] = *reinterpret_cast<const float2*>(rows[i4] + 4 * (32 * NG + 2 * gid));
            tile(acc[4 * NG], v[0].x, v[1].x, v[2].x, v[3].x);
            tile(acc[4 * NG + 1], v[0].y, v[1].y, v[2].y, v[3].y);
        }
    }
};

// Bytes of f32 q's staged terms (terms 1 and 2 of every k-step, in
// fragment order) for one row group
template <class C, class Q>
__host__ __device__ constexpr int q_stage_bytes() {
    return (Q::kQTerms - 1) * C::NK * 32 * 16;
}

template <class C, class Q>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
paged_attention_mma_kernel(const typename Q::T* __restrict__ q,      // [B, T, H, D]
                           const uint8_t* __restrict__ k_cache,      // [NB, BS, KH, Dp]
                           const uint8_t* __restrict__ v_cache,      // [NB, BS, KH, Dp]
                           const float* __restrict__ k_scale,        // [NB, KH] (quantized)
                           const float* __restrict__ v_scale,        // [NB, KH] (quantized)
                           const int32_t* __restrict__ block_tables, // [B, NBLK]
                           const int32_t* __restrict__ q_start,      // [B]
                           const int32_t* __restrict__ kv_lens,      // [B]
                           typename Q::T* __restrict__ out,          // [B, T, H, D] (1 split)
                           float* __restrict__ acc_out,              // [B, NS, KH, R, D]
                           float* __restrict__ m_out,                // [B, NS, KH, R]
                           float* __restrict__ l_out,                // [B, NS, KH, R]
                           int n_tok, int H, int KH, int BS, int NBLK, int spb, int n_rtiles,
                           int RW, float qscale) {
    constexpr int D = C::D;
    constexpr int S = C::kStages;
    extern __shared__ __align__(16) uint8_t smem[];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;  // MMA group: row gid / gid + 8, column gid
    const int tig = lane & 3;   // thread in group
    const int rep = H / KH;
    const int R = n_tok * rep;
    const int rtile = blockIdx.x % n_rtiles;
    const int kh = (blockIdx.x / n_rtiles) % KH;
    const int b = blockIdx.x / (n_rtiles * KH);
    const int split = blockIdx.y;
    const int ns = gridDim.y;
    const int rg = warp % RW;        // the warp's row group
    const int pl = warp / RW;        // its place among the row group's walkers
    const int PW = kWarps / RW;      // walkers of a row group
    const int row0 = (rtile * RW + rg) * kRows;
    const int qs = q_start[b];
    const int kv_len = kv_lens[b];
    // one ring for the whole CTA (bf16 with 2 or 4 row groups), else one a warp
    const bool shared = C::kSharedStage && RW > 1;

    // Q's A fragments for every k-step, rows gid (half 0) and gid + 8 (half
    // 1), word 2j + half of k-step kk holding the elements q_elem(kk, tig, j)
    // and the next; zeros past the last row. Term 0 stays in registers (qa);
    // f32 q's terms 1 and 2 go to the row group's q stage after the rings,
    // written by its first walker: word w of term t, k-step kk, lane L at
    // uint32 index (((t - 1) * NK + kk) * 32 + L) * 4 + w
    constexpr int QT = Q::kQTerms;
    const size_t ring_bytes = (size_t)(shared ? PW : kWarps) * S * C::STAGE;
    uint32_t* qx = reinterpret_cast<uint32_t*>(smem + ring_bytes
                                               + (size_t)rg * q_stage_bytes<C, Q>());
    int qpos[2];  // query position of the row; -1 past the last row
    uint32_t qa[C::NK][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = row0 + gid + 8 * half;
        qpos[half] = r < R ? qs + r / rep : -1;
        const typename Q::T* qrow =
            r < R ? q + (((size_t)b * n_tok + r / rep) * H + kh * rep + r % rep) * D : q;
#pragma unroll
        for (int kk = 0; kk < C::NK; ++kk) {
            if constexpr (QT == 1) {
                uint32_t w[2] = {0, 0};
                if (r < R)
                    Q::template load_kstep<C::kQAdjacent>(w, qrow, C::q_elem(kk, tig, 0),
                                                           C::q_elem(kk, tig, 1), qscale);
                qa[kk][half] = w[0];
                qa[kk][2 + half] = w[1];
            } else {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    uint32_t t[QT] = {};
                    if (r < R) Q::load_pair(t, qrow, C::q_elem(kk, tig, j), qscale);
                    qa[kk][2 * j + half] = t[0];
#pragma unroll
                    for (int i = 1; i < QT; ++i)
                        if (pl == 0)
                            qx[(((i - 1) * C::NK + kk) * 32 + lane) * 4 + 2 * j + half] = t[i];
                }
            }
        }
    }
    if constexpr (QT > 1) __syncthreads();  // the q stage is written
    const uint4* qx_lane = reinterpret_cast<const uint4*>(qx) + lane;

    // The units of rows up to last_row: the split's blocks, cut at the row's
    // last used block (ragged early exit) and at last_row's last visible
    // position.
    const int U = BS / kUnit;
    const int u_begin = split * spb * U;
    auto units_end = [&](int last_row) {
        const int used_blocks = min((kv_len + BS - 1) / BS, NBLK);
        const int g_end = min(used_blocks, (split + 1) * spb);
        const int vis_end = min(kv_len, qs + last_row / rep + 1);
        return min(g_end * U, (vis_end + kUnit - 1) / kUnit);
    };
    auto count = [&](int end, int first) {  // units first, first + PW, ... before end
        return end > first ? (end - first + PW - 1) / PW : 0;
    };
    // The warp consumes every PW-th unit of its row group from its place:
    // unit u_begin + pl + i * PW at step i. A private ring holds only the
    // warp's units; a shared one holds at step i units u_begin + i * PW + p
    // (p < PW) up to the end of the CTA's last row, unit p copied by the
    // warps with warp % PW == p. A step is one ring item, or with kSplitKV
    // two: the unit's K rows (item 2i), then its V rows (item 2i + 1).
    const int n_my = row0 < R ? count(units_end(min(row0 + kRows, R) - 1), u_begin + pl) : 0;
    const int pc = shared ? warp % PW : pl;  // the unit slot this warp copies
    int n_copy = n_my, n_steps = n_my;       // units it copies, steps of the walk
    if (shared) {
        const int cta_end = units_end(min((rtile + 1) * RW * kRows, R) - 1);
        n_copy = count(cta_end, u_begin + pc);
        n_steps = count(cta_end, u_begin);
    }
    const int c_first = shared ? (warp / PW) * 32 + lane : lane;
    const int c_stride = shared ? 32 * RW : 32;
    const int slot_units = shared ? PW : 1;
    uint8_t* ring = shared ? smem : smem + (size_t)warp * S * C::STAGE;

    const size_t row_stride = (size_t)KH * C::Dp;
    const int32_t* bt_row = block_tables + (size_t)b * NBLK;
    int blk_vec = 0;  // block of the warp's copied unit (32-aligned base) + lane
    constexpr int HV = C::kSplitKV ? 2 : 1;  // ring items a step

    // copy item i of unit u_begin + pc + (i / HV) * PW (K rows, V rows,
    // scales; or with kSplitKV its K rows for even i, V rows for odd) into
    // the item's stage
    auto issue = [&](int i) {
        const int us = i / HV;
        if (us % 32 == 0 && i % HV == 0) {
            const int ii = us + lane;
            blk_vec = ii < n_copy ? bt_row[(u_begin + pc + ii * PW) / U] : 0;
        }
        const int u = u_begin + pc + us * PW;
        const int blk = __shfl_sync(kFull, blk_vec, us % 32);
        uint8_t* st = ring + ((i % S) * slot_units + (shared ? pc : 0)) * C::STAGE;
        const size_t base = ((size_t)blk * BS + (size_t)(u % U) * kUnit) * row_stride
                            + (size_t)kh * C::Dp;
        const uint8_t* first = HV == 2 && i % 2 ? v_cache : k_cache;
        for (int c = c_first; c < kUnit * C::CPR; c += c_stride) {
            const int row = c / C::CPR;
            const int ch = c % C::CPR;
            const size_t src = base + row * row_stride + ch * C::CB;
            cp_async<C::CB>(st + row * C::SP + ch * C::CB, first + src);
            if constexpr (HV == 1)
                cp_async<C::CB>(st + (kUnit + row) * C::SP + ch * C::CB, v_cache + src);
        }
        if (C::kScaled && lane < 2)
            cp_async<4>(st + 2 * kUnit * C::SP + 4 * lane,
                        (lane == 0 ? k_scale : v_scale) + (size_t)blk * KH + kh);
    };
    // the ring's readers: the warp (private) or the CTA (shared)
    auto sync_ring = [&]() {
        if (shared)
            __syncthreads();
        else
            __syncwarp();
    };

    float acc[C::NN][4];
#pragma unroll
    for (int j = 0; j < C::NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end

    // P's A fragments (one a term), the softmax rescale and the V scale:
    // from a step's scores to its p.v
    constexpr int PT = Q::kPTerms;
    uint32_t pa[PT][4];
    float alpha[2];
    float vs = 1.f;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < n_copy * HV) issue(s);
        cp_async_commit();
    }
    for (int i = 0; i < n_steps * HV; ++i) {
        if (i + S - 1 < n_copy * HV) issue(i + S - 1);
        cp_async_commit();
        cp_async_wait<S - 1>();  // item i has landed
        sync_ring();
        if (i / HV < n_my) {
            const uint8_t* st = ring + ((i % S) * slot_units + (shared ? pl : 0)) * C::STAGE;
            if (i % HV == 0) {
                float ks = 1.f;
                if constexpr (C::kScaled) {
                    ks = reinterpret_cast<const float*>(st + 2 * kUnit * C::SP)[0];
                    vs = reinterpret_cast<const float*>(st + 2 * kUnit * C::SP)[1];
                }
                const int pos0 = (u_begin + pl + (i / HV) * PW) * kUnit;

                float s[2][4];
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
                C::template scores<QT>(s, qa, qx_lane, st, lane);

                // online softmax; s[n][e] is row gid + 8*(e>>1), position
                // pos0 + 8n + 2tig + (e&1)
                float mx[2] = {kNegInf, kNegInf};
                bool vis[2][4];
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int h = e >> 1;
                        const int pos = pos0 + 8 * n + 2 * tig + (e & 1);
                        vis[n][e] = pos <= qpos[h] && pos < kv_len;
                        s[n][e] = vis[n][e] ? s[n][e] * ks : kNegInf;
                        mx[h] = fmaxf(mx[h], s[n][e]);
                    }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
                    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
                    const float m_new = fmaxf(m[h], mx[h]);
                    alpha[h] = expf(m[h] - m_new);
                    m[h] = m_new;
                    l[h] *= alpha[h];
                }
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int h = e >> 1;
                        s[n][e] = vis[n][e] ? expf(s[n][e] - m[h]) : 0.f;
                        l[h] += s[n][e];
                    }
                // P's A fragments, one a term: S's accumulators, word i from
                // s[i / 2][2 (i % 2)], s[i / 2][2 (i % 2) + 1]
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    uint32_t t[PT];
                    split_bf16<PT>(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1], t);
#pragma unroll
                    for (int k = 0; k < PT; ++k) pa[k][i] = t[k];
                }
            }
            if (i % HV == HV - 1)  // the unit's V rows: after its K rows, or the item's own
                C::template pv<PT>(acc, pa, st + (HV == 1 ? kUnit * C::SP : 0), lane, alpha, vs);
        }
        sync_ring();  // the stage is consumed before it is refilled
    }
    cp_async_wait<0>();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(kFull, l[h], 1);
        l[h] += __shfl_xor_sync(kFull, l[h], 2);
    }

    if (PW == 1) {
        // each warp holds its row group alone: write from registers (the
        // merge below would weigh its one walker by expf(0) = 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + gid + 8 * h;
            if (r >= R) continue;
            if (ns == 1) {
                typename Q::T* o =
                    out + (((size_t)b * n_tok + r / rep) * H + kh * rep + r % rep) * D;
                const float L = l[h] == 0.f ? 1.f : l[h];  // all-masked rows -> 0
#pragma unroll
                for (int j = 0; j < C::NN; ++j)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e)
                        o[C::dmap(j, 2 * tig + (e & 1))] = Q::to_out(acc[j][e] / L);
            } else {
                const size_t srow = (((size_t)b * ns + split) * KH + kh) * R + r;
#pragma unroll
                for (int j = 0; j < C::NN; ++j)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e)
                        acc_out[srow * D + C::dmap(j, 2 * tig + (e & 1))] = acc[j][e];
                if (tig == 0) {
                    m_out[srow] = m[h];
                    l_out[srow] = l[h];
                }
            }
        }
        return;
    }

    // merge the walkers of each row group (the rings and the q stage are
    // free now)
    __syncthreads();
    float* sm_acc = reinterpret_cast<float*>(smem);   // [kWarps][16][MS]
    float* sm_m = sm_acc + kWarps * kRows * C::MS;     // [kWarps][16]
    float* sm_l = sm_m + kWarps * kRows;               // [kWarps][16]
#pragma unroll
    for (int j = 0; j < C::NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e >> 1);
            sm_acc[C::merge_idx(warp * kRows + row, C::dmap(j, 2 * tig + (e & 1)))] = acc[j][e];
        }
    if (tig == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            sm_m[warp * kRows + gid + 8 * h] = m[h];
            sm_l[warp * kRows + gid + 8 * h] = l[h];
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RW * kRows * D; e += kThreads) {
        const int d = e % D;
        const int lr = (e / D) % kRows;
        const int g = e / (kRows * D);
        const int r = (rtile * RW + g) * kRows + lr;
        if (r >= R) continue;
        float M = kNegInf;
        for (int p = 0; p < PW; ++p) M = fmaxf(M, sm_m[(g + RW * p) * kRows + lr]);
        float L = 0.f, O = 0.f;
        for (int p = 0; p < PW; ++p) {
            const int w = g + RW * p;
            const float wt = expf(sm_m[w * kRows + lr] - M);
            L += wt * sm_l[w * kRows + lr];
            O += wt * sm_acc[C::merge_idx(w * kRows + lr, d)];
        }
        if (ns == 1) {
            const int h = kh * rep + r % rep;
            out[(((size_t)b * n_tok + r / rep) * H + h) * D + d] =
                Q::to_out(O / (L == 0.f ? 1.f : L));  // all-masked rows -> 0
        } else {
            const size_t srow = (((size_t)b * ns + split) * KH + kh) * R + r;
            acc_out[srow * D + d] = O;
            if (d == 0) {
                m_out[srow] = M;
                l_out[srow] = L;
            }
        }
    }
}

template <class C, class Q>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int32_t* bt, const int32_t* qs, const int32_t* kl, void* out, float* acc,
           float* m, float* l, int B, int n_tok, int H, int KH, int BS, int NBLK, int ns,
           int spb, int RW, float qscale, cudaStream_t stream) {
    const int R = n_tok * (H / KH);
    const int n_rtiles = (R + kRows * RW - 1) / (kRows * RW);
    const int rings = C::kSharedStage && RW > 1 ? kWarps / RW : kWarps;  // items a stage
    const size_t ring = (size_t)rings * C::kStages * C::STAGE
                        + (size_t)RW * q_stage_bytes<C, Q>();
    const size_t merge = RW == kWarps ? 0  // one walker a row group: no merge
                         : sizeof(float) * ((size_t)kWarps * kRows * C::MS + 2 * kWarps * kRows);
    const size_t smem = ring > merge ? ring : merge;
    auto kernel = paged_attention_mma_kernel<C, Q>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((unsigned)(B * KH * n_rtiles), (unsigned)ns);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const typename Q::T*>(q), static_cast<const uint8_t*>(k),
        static_cast<const uint8_t*>(v), ks, vs, bt, qs, kl, static_cast<typename Q::T*>(out),
        acc, m, l, n_tok, H, KH, BS, NBLK, spb, n_rtiles, RW, qscale);
    return (int)cudaGetLastError();
}

template <template <int> class Policy, class Q>
int dispatch_d(int D, const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int32_t* bt, const int32_t* qs, const int32_t* kl,
               void* out, float* acc, float* m, float* l, int B, int n_tok, int H, int KH,
               int BS, int NBLK, int ns, int spb, int RW, float qscale, cudaStream_t stream) {
    switch (D) {
#define DYN_MMA_D(N)                                                                       \
    case N:                                                                                \
        return launch<Policy<N>, Q>(q, k, v, ks, vs, bt, qs, kl, out, acc, m, l, B, n_tok, \
                                    H, KH, BS, NBLK, ns, spb, RW, qscale, stream);
        DYN_MMA_D(16) DYN_MMA_D(32) DYN_MMA_D(48) DYN_MMA_D(64)
        DYN_MMA_D(80) DYN_MMA_D(96) DYN_MMA_D(112) DYN_MMA_D(128)
        DYN_MMA_D(144) DYN_MMA_D(160) DYN_MMA_D(176) DYN_MMA_D(192)
        DYN_MMA_D(208) DYN_MMA_D(224) DYN_MMA_D(240) DYN_MMA_D(256)
#undef DYN_MMA_D
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// The build (ops/build.py) compiles this source once for each (cache,
// query) policy pair, all at once: with DYN_MMA_PAIR = n the translation
// unit holds pair n's 16 head-dim instantiations behind
// dyn_paged_attention_mma_pair_n; without it, only the C entry point, which
// picks the pair. The pairs' units are what take nvcc's time.
#define DYN_MMA_PAIR_PARAMS                                                                 \
    int D, const void *q, const void *k, const void *v, const float *ks, const float *vs,  \
        const int32_t *bt, const int32_t *qs, const int32_t *kl, void *out, float *acc,    \
        float *m, float *l, int B, int n_tok, int H, int KH, int BS, int NBLK, int ns,      \
        int spb, int RW, float qscale, cudaStream_t stream

extern "C" {

#ifdef DYN_MMA_PAIR

#if DYN_MMA_PAIR == 0
#define DYN_MMA_POLICIES Bf16Cache, QueryBf16
#elif DYN_MMA_PAIR == 1
#define DYN_MMA_POLICIES Int8Cache, QueryBf16
#elif DYN_MMA_PAIR == 2
#define DYN_MMA_POLICIES Int4Cache, QueryBf16
#elif DYN_MMA_PAIR == 3
#define DYN_MMA_POLICIES F32Cache, QueryF32
#elif DYN_MMA_PAIR == 4
#define DYN_MMA_POLICIES Int8Cache, QueryF32
#elif DYN_MMA_PAIR == 5
#define DYN_MMA_POLICIES Int4Cache, QueryF32
#else
#error "DYN_MMA_PAIR must be 0..5"
#endif
#define DYN_MMA_NAME2(n) dyn_paged_attention_mma_pair_##n
#define DYN_MMA_NAME(n) DYN_MMA_NAME2(n)

int DYN_MMA_NAME(DYN_MMA_PAIR)(DYN_MMA_PAIR_PARAMS) {
    return dispatch_d<DYN_MMA_POLICIES>(D, q, k, v, ks, vs, bt, qs, kl, out, acc, m, l, B,
                                        n_tok, H, KH, BS, NBLK, ns, spb, RW, qscale, stream);
}

#else  // the entry point

int dyn_paged_attention_mma_pair_0(DYN_MMA_PAIR_PARAMS);  // Bf16Cache, QueryBf16
int dyn_paged_attention_mma_pair_1(DYN_MMA_PAIR_PARAMS);  // Int8Cache, QueryBf16
int dyn_paged_attention_mma_pair_2(DYN_MMA_PAIR_PARAMS);  // Int4Cache, QueryBf16
int dyn_paged_attention_mma_pair_3(DYN_MMA_PAIR_PARAMS);  // F32Cache, QueryF32
int dyn_paged_attention_mma_pair_4(DYN_MMA_PAIR_PARAMS);  // Int8Cache, QueryF32
int dyn_paged_attention_mma_pair_5(DYN_MMA_PAIR_PARAMS);  // Int4Cache, QueryF32

// q_dtype: 0 = bf16 q and out, 1 = f32 q and out. q is unscaled: the
// kernel multiplies it by qscale = D^-0.5 rounded to q's dtype, rounding the
// product to q's dtype. cache_kind: 0 = model precision, q's dtype: bf16 or
// f32 payload [NB, BS, KH, D] (scales unused), 1 = int8 payload [NB, BS,
// KH, D], 2 = packed int4 uint8 payload [NB, BS, KH, D/2]; 1 and 2 take f32
// scales [NB, KH] for K and V. D a multiple of 16 up to 256, BS a multiple of 16;
// RW = row groups of 16 query rows a CTA holds (1, 2 or 4). ns == 1 writes
// normalised rows to `out`; ns > 1 writes each split's raw (acc, m, l) and
// leaves `out` alone. Returns cudaGetLastError() of the launch (0 =
// launched), cudaErrorInvalidValue for what it does not take.
int dyn_paged_attention_mma(int q_dtype, int cache_kind, const void* q, const void* k_cache,
                            const void* v_cache, const float* k_scale, const float* v_scale,
                            const int32_t* block_tables, const int32_t* q_start,
                            const int32_t* kv_lens, void* out, float* acc, float* m, float* l,
                            int B, int n_tok, int H, int KH, int D, int BS, int NBLK, int ns,
                            int spb, int RW, float qscale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (BS % kUnit != 0 || !(RW == 1 || RW == 2 || RW == 4)) return (int)cudaErrorInvalidValue;
    if (q_dtype < 0 || q_dtype > 1 || cache_kind < 0 || cache_kind > 2)
        return (int)cudaErrorInvalidValue;
    int (*const pairs[6])(DYN_MMA_PAIR_PARAMS) = {
        dyn_paged_attention_mma_pair_0, dyn_paged_attention_mma_pair_1,
        dyn_paged_attention_mma_pair_2, dyn_paged_attention_mma_pair_3,
        dyn_paged_attention_mma_pair_4, dyn_paged_attention_mma_pair_5};
    return pairs[3 * q_dtype + cache_kind](D, q, k_cache, v_cache, k_scale, v_scale,
                                           block_tables, q_start, kv_lens, out, acc, m, l, B,
                                           n_tok, H, KH, BS, NBLK, ns, spb, RW, qscale, s);
}

#endif  // DYN_MMA_PAIR

}  // extern "C"
