// The 'balanced' and 'fast' tiers of the SED projection, for Hopper (sm_90a):
// a phase table made once per call, then a wgmma product fed by a TMA ring.
//
//   out_re[t, c, k] = sum_a data[t, a, c] * cos(A[a, k])
//   out_im[t, c, k] = sum_a data[t, a, c] * sin(A[a, k])
//   A[a, k]         = (mp_hi + mp_lo)[a] . kv[k], formed and folded in float64
//
// Replaces the Pallas TPU kernel psa_tpu/ops/pallas_sed.py::sed_projection_pallas
// (body _projection_kernel, angle tile _angles_tile) at Precision.HIGH
// ('balanced') and Precision.DEFAULT ('fast').  'parity' stays in
// sed_projection.cu.
//
// As a matrix product: M = 3 n_t rows (t, c), N = 2K columns (cos | sin),
// depth A.  What bounds it, per working chunk (n_t, A, K) = (1e4, 1e5, 500):
//   * tensor work: 2 M N A = 6.0e12 flop per product: 12.121 ms at the
//     card's 495 TFLOP/s dense TF32 ('fast', one product) and 6.067 ms at
//     989 TFLOP/s bf16 per product ('balanced' does three: 18.2 ms).
//   * memory: 12.12 GB of input (the trajectory once) at 3.35 TB/s: 3.62 ms.
// The fused kernel of sed_projection.cu remakes the (atom, k) angles for
// every time tile, ceil(n_t / 64) A K = 7.85e9 of them per call, and their
// float64 math and sincosf, not the products, set its pace.  Here:
//   * The table kernel makes each angle once per call, A K = 5e7 of them:
//     the float64 dot and fold, the accurate sincosf (this file must not be
//     built with --use_fast_math), the tier's split (TF32 by cvt.rna, or
//     bf16 hi = rn(x), lo = rn(x - hi)), written into a scratch the wrapper
//     allocates (A 2K 4 bytes, 0.4 GB at the working chunk), already in the
//     order of the product's shared-memory B tiles: K-major core matrices
//     (8 columns x 16 bytes of atoms, no swizzle), one contiguous 16 KB tile
//     per (k-tile, stage of BA atoms), tile (kt, s) at (kt n_stages + s) 16 KB.
//   * The product kernel runs m64n128 wgmma (BN = 128 columns = 64 k-points,
//     twice the fused kernel's tile, so the data are read and split half as
//     often).  A ring of NS stages in shared memory is filled by the TMA
//     unit behind mbarriers, NS - 1 stages ahead, each slot once every warp
//     has released it: per stage one bulk copy (cp.async.bulk) of the 16 KB
//     B tile and four 2D tensor copies of the data tile (64 time steps x
//     the stage's 3 BA floats).  A row of 3A floats lies on a 16-byte
//     boundary only when A % 4 == 0, and a tensor map's strides must be
//     16-byte multiples; time steps t and t + 4 lie 12A floats apart, which
//     is, so the data are four maps, one per residue of t mod 4, each
//     starting at the data pointer; a copy starts at the 16-byte boundary
//     below the stage's first float, as the TMA unit needs.  (One bulk copy
//     per time step, or 16-byte cp.async pieces from every thread, were far
//     slower: the TMA unit takes many small copies slowly, and the pieces
//     cost instruction slots and a block-wide wait per stage.)  Three warpgroups,
//     one per component, load the data tile from shared memory into A
//     fragments, split as the tier splits, and multiply by the B tiles in
//     shared memory.  Warp 0 refills the ring between its own stages: the
//     whole warp waits for the slot to be released, lane 0 starts the
//     copies, and the warp meets again before its next warp-collective
//     wgmma.  So the block moves at the pace of its slowest warp.  No
//     producer warp: a 13th warp makes ptxas budget the block as 16 warps,
//     128 registers a thread, and the chain sum and the partial alone take
//     2 x 64; 384 threads get 168.  A producer warpgroup that gives its
//     registers to the consumers with setmaxnreg faulted with an illegal
//     instruction on its second launch, for a reason not yet found.
//   * The sum is the fused kernel's: the tensor cores add to their float32
//     accumulator with truncation, so the MMAs of each CHAIN_ATOMS atoms
//     start from zero and are added to a register partial in IEEE float32;
//     every SUM_ATOMS atoms the partial is added to a running total in
//     shared memory.  One block walks the whole atom axis of its output
//     tile (BT = 64 time steps by 64 k-points): no split of the atom axis,
//     no atomics, the same result in every run.
//   * A TF32xTF32 or bf16xbf16 product is exact in float32, so each tier
//     differs from its plain version (ops/sed_projection.py, which rounds the
//     operands the same way) only in the order of the sum.
//   * The L2 carries each block's data and B tiles, about 42 KB per stage of
//     32 atoms against 1.6e6 flop of one product: the blocks in flight share
//     a few time tiles (k-tile fastest), so the trajectory comes from HBM
//     about once and the table about once per wave.
//
// Measured on an NVIDIA H100 80GB HBM3, 700 W power limit, at the working
// chunk (chip_smoke.py phase 5d): 'fast' 30.3 ms (table 0.17 + product
// 30.2; the fused design took 72.5), 'balanced' 43.3 ms (0.23 + 42.2; the
// fused design 98.5), within 3% at A = 99,999.  The library is faster on
// the product stage alone: cuBLAS takes 19.2 ms for the TF32 product and
// 39.3 ms for the three bf16 products (with bf16 outputs).  162 and 168
// registers, no spill.
//
// Entry points launch on the given stream, do not synchronise, allocate
// nothing, and return the first CUDA error (0 if none).  The wrapper walks
// the atom axis in blocks when the table would pass its cap: the table of a
// block, then its product, the later blocks added through accumulate.

#include <cuda.h>            // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;                    // time steps per block
constexpr int BM = 3 * BT;                // output rows (t, c) per block: 192
constexpr int BK = 64;                    // k-points per tile
constexpr int BN = 2 * BK;                // MMA columns per tile (cos | sin): 128
constexpr int BA = 32;                    // atoms per pipeline stage
constexpr int NS = 3;                     // stages in the shared-memory ring
constexpr int SUM_ATOMS = 256;            // atoms per fresh partial sum
constexpr int CHAIN_ATOMS = 32;           // atoms per fresh MMA sum, then added in IEEE float32
constexpr int TF32_DEPTH = 8;             // atoms per TF32 wgmma k-step
constexpr int BF16_DEPTH = 16;            // atoms per bf16 wgmma k-step
constexpr int THREADS = 128 * (BM / 64);  // one warpgroup per 64 rows: 384 (168 registers each)
constexpr int ACC = BN / 2;               // accumulators per thread (m64n128): 64
constexpr int ROW_FLOATS = 3 * BA;        // floats of one time step and stage: 96
constexpr int RESIDUES = 4;               // tensor maps of the data: time steps t % 4 == r
constexpr int BOX_ROWS = BT / RESIDUES;   // time steps of one tensor copy: 16
constexpr int DATA_BOX = 100;             // floats per row of a tensor copy (the box's width)
constexpr int DATA_STAGE = BT * DATA_BOX; // floats of one data slot
constexpr int STAGE_BYTES = BA * BN * 4;  // one B tile, either tier: 16384
constexpr int SMEM_BYTES = NS * (STAGE_BYTES + DATA_STAGE * (int)sizeof(float))
    + ACC * THREADS * (int)sizeof(float) + 2 * NS * (int)sizeof(uint64_t);
constexpr int TABLE_THREADS = 256;

static_assert(BM % 64 == 0 && BN == 128, "m64n128 warpgroup tiles");
static_assert(SUM_ATOMS % BA == 0, "partials restart on stage boundaries");
static_assert(BA % CHAIN_ATOMS == 0 && CHAIN_ATOMS % BF16_DEPTH == 0, "MMA sums within a stage");
static_assert(SMEM_BYTES <= 232448, "H100 shared memory per block");
static_assert(DATA_BOX >= ROW_FLOATS + 3 && (DATA_BOX * 4) % 16 == 0 && BM / 64 == 3
              && (BOX_ROWS * DATA_BOX * 4) % 128 == 0 && (NS * STAGE_BYTES) % 128 == 0
              && BOX_ROWS == 16 && BT % (4 * RESIDUES) == 0,
              "a box row holds a stage; boxes on 128-byte boundaries; one warpgroup per "
              "component, one warp per residue, its 16 rows one box");

constexpr double TWO_PI = 6.283185307179586476925286766559;
constexpr double INV_TWO_PI = 0.15915494309189533576888376337251;

// Tiers, as the wrapper's TIERS numbers them ('parity', 0, runs in
// sed_projection.cu).
constexpr int BALANCED = 1, FAST = 2;

// Per tier: atoms per k-step (KATOMS), bytes per B element (ELEM), parts
// of the table (PARTS: hi and lo, or one), atoms per core-matrix row.
template <int TIER> struct Tier {
    static constexpr int KATOMS = TIER == BALANCED ? BF16_DEPTH : TF32_DEPTH;
    static constexpr int ELEM = TIER == BALANCED ? 2 : 4;
    static constexpr int PARTS = TIER == BALANCED ? 2 : 1;
    static constexpr int CORE_ATOMS = 16 / ELEM;
};

// B tile layout (one stage, STAGE_BYTES): per k-step ks and part p a
// 2 x 16 grid of K-major core matrices, 8 columns x 16 bytes each: atom
// al = ks KATOMS + a of the stage, column n (n < BK: cos of k-point n of
// the tile; else sin of k-point n - BK) at byte
//   (((ks PARTS + p) 2 + a / CORE_ATOMS) 16 + n / 8) 128 + (n % 8) 16 + (a % CORE_ATOMS) ELEM.
constexpr uint32_t CORE_N_STEP = 128;               // next 8 columns (SBO)
constexpr uint32_t CORE_K_STEP = (BN / 8) * 128;    // next 16 bytes of atoms (LBO): 2048
constexpr uint32_t PART_BYTES = 2 * CORE_K_STEP;    // one k-step's hi or lo tile: 4096

template <int TIER>
__device__ __forceinline__ uint32_t b_byte(int al, int n)
{
    using T = Tier<TIER>;
    const int ks = al / T::KATOMS, a = al % T::KATOMS;
    return (ks * T::PARTS * 2 + a / T::CORE_ATOMS) * CORE_K_STEP + (n / 8) * CORE_N_STEP
         + (n % 8) * 16 + (a % T::CORE_ATOMS) * T::ELEM;
}

// TF32 as cvt.rna.tf32.f32 rounds (add 0x1000 to the bits, clear the low 13).
__device__ __forceinline__ uint32_t tf32_rna(float x)
{
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The bits of rn_bf16(x) (to nearest, ties to even) in the high half of a
// float's bits, the low half zero; x finite.
__device__ __forceinline__ uint32_t bf16_rn(float x)
{
    const uint32_t u = __float_as_uint(x);
    return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// The 3xBF16 split: hi = rn_bf16(x), lo = rn_bf16(x - hi) (x - hi is exact
// in float32), each as its 16 bits.
__device__ __forceinline__ void split_bf16(float x, uint32_t& hi, uint32_t& lo)
{
    const uint32_t h = bf16_rn(x);
    hi = h >> 16;
    lo = bf16_rn(x - __uint_as_float(h)) >> 16;
}

// ---- the table kernel ------------------------------------------------------

// Block (kt, s) makes B tile kt n_stages + s: k-points kt BK .. of kv,
// atoms atom0 + s BA .. of the positions.  A thread item is one k-point and
// one core-matrix row of atoms (4 TF32 or 8 bf16): 16 bytes per part of
// its cos column and as many of its sin column.  Atoms past n_atoms and
// k-points past n_k are zero.
template <int TIER>
__global__ void __launch_bounds__(TABLE_THREADS)
tier_table_kernel(const float* __restrict__ mp_hi, const float* __restrict__ mp_lo,
                  const float* __restrict__ kv, unsigned char* __restrict__ table,
                  long long atom0, long long n_atoms, long long n_k, int n_stages)
{
    using T = Tier<TIER>;
    constexpr int CORE = T::CORE_ATOMS;
    __shared__ double s_pos[BA * 3], s_k[BK * 3];
    const int s = blockIdx.x % n_stages, kt = blockIdx.x / n_stages;
    const long long a_first = (long long)s * BA, k_first = (long long)kt * BK;
    for (int i = threadIdx.x; i < BA * 3; i += TABLE_THREADS) {
        const long long a = a_first + i / 3;
        const long long o = (atom0 + a) * 3 + i % 3;
        s_pos[i] = a < n_atoms ? (double)mp_hi[o] + (double)mp_lo[o] : 0.0;
    }
    for (int i = threadIdx.x; i < BK * 3; i += TABLE_THREADS) {
        const long long k = k_first + i / 3;
        s_k[i] = k < n_k ? (double)kv[k * 3 + i % 3] : 0.0;
    }
    __syncthreads();

    unsigned char* tile = table + (size_t)blockIdx.x * STAGE_BYTES;
    for (int item = threadIdx.x; item < (BA / CORE) * BK; item += TABLE_THREADS) {
        const int kl = item % BK, ag = item / BK;
        const bool k_ok = k_first + kl < n_k;
        float cs[CORE], sn[CORE];
#pragma unroll
        for (int j = 0; j < CORE; ++j) {
            const int al = ag * CORE + j;
            double ang = s_pos[3 * al] * s_k[3 * kl] + s_pos[3 * al + 1] * s_k[3 * kl + 1]
                       + s_pos[3 * al + 2] * s_k[3 * kl + 2];
            ang -= TWO_PI * rint(ang * INV_TWO_PI);
            sincosf((float)ang, &sn[j], &cs[j]);
            if (!(k_ok && a_first + al < n_atoms))
                cs[j] = sn[j] = 0.0f;
        }
        unsigned char* at_cos = tile + b_byte<TIER>(ag * CORE, kl);
        unsigned char* at_sin = tile + b_byte<TIER>(ag * CORE, BK + kl);
        if constexpr (TIER == BALANCED) {
            uint32_t hc[CORE], lc[CORE], hs[CORE], ls[CORE];
#pragma unroll
            for (int j = 0; j < CORE; ++j) {
                split_bf16(cs[j], hc[j], lc[j]);
                split_bf16(sn[j], hs[j], ls[j]);
            }
            auto pack = [](const uint32_t (&v)[CORE]) {
                return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                                  v[4] | (v[5] << 16), v[6] | (v[7] << 16));
            };
            *reinterpret_cast<uint4*>(at_cos) = pack(hc);
            *reinterpret_cast<uint4*>(at_cos + PART_BYTES) = pack(lc);
            *reinterpret_cast<uint4*>(at_sin) = pack(hs);
            *reinterpret_cast<uint4*>(at_sin + PART_BYTES) = pack(ls);
        } else {
            *reinterpret_cast<uint4*>(at_cos) =
                make_uint4(tf32_rna(cs[0]), tf32_rna(cs[1]), tf32_rna(cs[2]), tf32_rna(cs[3]));
            *reinterpret_cast<uint4*>(at_sin) =
                make_uint4(tf32_rna(sn[0]), tf32_rna(sn[1]), tf32_rna(sn[2]), tf32_rna(sn[3]));
        }
    }
}

// ---- the product kernel ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity)
{
    asm volatile("{\n.reg .pred done;\nWAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "@!done bra WAIT;\n}" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The (BOX_ROWS x DATA_BOX floats) box of a data map at (c0, c1) by the TMA
// unit, completing on `bar`; elements past the map's extent are zero.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];"
                 :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                    "r"(smem_addr(bar)) : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, then the byte
// offsets between core matrices along K (LBO) and along N (SBO), each in
// 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(CORE_K_STEP >> 4) << 16)
         | ((uint64_t)(CORE_N_STEP >> 4) << 32);
}

#define PSA_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PSA_D64 PSA_D8(0), PSA_D8(8), PSA_D8(16), PSA_D8(24), PSA_D8(32), PSA_D8(40), \
                PSA_D8(48), PSA_D8(56)
#define PSA_ACC_REGS                                                                      \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
    "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d = a * b (+ d if accumulate) for one warpgroup, m64n128k8 with TF32
// inputs: a from registers (the m16n8k8 A fragment of each warp's 16 rows),
// b K-major from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " PSA_ACC_REGS ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}"
        : PSA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// The same for m64n128k16 with bf16 inputs: a is the m16n8k16 A fragment
// (two bf16 per register, the lower column in the low half); b K-major
// (the last immediate, imm-trans-b, is 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PSA_ACC_REGS ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
        : PSA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n\twgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The A fragment of one k-step from the data tile: r0 and r1 point at the
// k-step's first atom of this thread in rows g and g + 8; `left` is how
// many atoms of the stage lie at or after that first atom (MASKED: the
// others are zero).  TF32: atoms tq and tq + 4 (floats 0 and 12 on); BF16:
// atoms 2tq, 2tq + 1, 2tq + 8 and 2tq + 9 (floats 0, 3, 24 and 27 on),
// hi and lo packed in pairs.
template <int TIER, bool MASKED>
__device__ __forceinline__ void load_a(const float* r0, const float* r1, int left,
                                       uint32_t (&big)[4], uint32_t (&small)[4])
{
    auto at = [&](const float* r, int i) {   // atom i after the first, or zero past the end
        return !MASKED || i < left ? r[3 * i] : 0.0f;
    };
    if constexpr (TIER == BALANCED) {
        const float* rows[2] = {r0, r1};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = 8 * (j / 2);
            uint32_t h0, l0, h1, l1;
            split_bf16(at(rows[j % 2], i), h0, l0);
            split_bf16(at(rows[j % 2], i + 1), h1, l1);
            big[j] = h0 | (h1 << 16);
            small[j] = l0 | (l1 << 16);
        }
    } else {
        big[0] = tf32_rna(at(r0, 0));
        big[1] = tf32_rna(at(r1, 0));
        big[2] = tf32_rna(at(r0, 4));
        big[3] = tf32_rna(at(r1, 4));
    }
}

// One stage's products into the partial `acc`: per CHAIN_ATOMS atoms the
// MMAs from zero into `step` (for 'balanced' per k-step lo*hi, hi*lo, then
// hi*hi, so the truncating accumulator adds the big term last), then
// acc += step in IEEE float32.  The A fragments of k-step q + 1 are loaded
// and split while the MMAs of k-step q run.  `left` counts the stage's
// atoms from this thread's first atom on (used when MASKED).
template <int TIER, bool MASKED>
__device__ __forceinline__ void stage_products(const float* sd, uint32_t sb, const int (&row_at)[2],
                                               int left, float (&step)[ACC], float (&acc)[ACC])
{
    using T = Tier<TIER>;
    constexpr int KSTEPS = BA / T::KATOMS, CHAIN = CHAIN_ATOMS / T::KATOMS;
#pragma unroll
    for (int k0s = 0; k0s < KSTEPS; k0s += CHAIN) {
        uint32_t a_big[CHAIN][4], a_small[CHAIN][4];
        auto load = [&](int q) {
            const int first = 3 * T::KATOMS * (k0s + q);
            load_a<TIER, MASKED>(sd + row_at[0] + first, sd + row_at[1] + first,
                                 left - T::KATOMS * (k0s + q), a_big[q], a_small[q]);
        };
        load(0);
#pragma unroll
        for (int q = 0; q < CHAIN; ++q) {
            wgmma_fence();
            const uint32_t b = sb + T::PARTS * (k0s + q) * PART_BYTES;
            if constexpr (TIER == BALANCED) {
                wgmma_bf16(step, a_small[q], smem_desc(b), q > 0);
                wgmma_bf16(step, a_big[q], smem_desc(b + PART_BYTES), 1);
                wgmma_bf16(step, a_big[q], smem_desc(b), 1);
            } else {
                wgmma_tf32(step, a_big[q], smem_desc(b), q > 0);
            }
            if (q + 1 < CHAIN)
                load(q + 1);
        }
        wgmma_commit_wait();
#pragma unroll
        for (int i = 0; i < ACC; ++i)
            acc[i] += step[i];
    }
}

// The data as RESIDUES tensor maps: map r holds the time steps t = 4 u + r
// as rows u, 12 row_atoms floats apart (16-byte multiples whatever
// row_atoms is), and floats 0 .. (r + 1) 3 row_atoms of each (the inner
// coordinate r 3 row_atoms + f is float f of time step 4 u + r, past the
// row's end is outside the map).  All start at the data pointer itself.
struct DataMaps {
    CUtensorMap map[RESIDUES];
};

// Block (tt, kt), kt fastest: rows t0 = tt BT .. of the output, k-points
// kt BK .. ; atoms atom0 .. atom0 + n_atoms of rows that hold row_atoms
// atoms each; B tiles kt n_stages .. of the table.
template <int TIER>
__global__ void __launch_bounds__(THREADS, 1)
tier_product_kernel(const __grid_constant__ DataMaps maps, const unsigned char* __restrict__ table,
                    float* __restrict__ out_re, float* __restrict__ out_im,
                    long long n_t, long long row_atoms, long long atom0, long long n_atoms,
                    long long n_k, int grid_k, int accumulate)
{
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* s_b = smem;                                              // NS B tiles
    float* s_data = reinterpret_cast<float*>(smem + NS * STAGE_BYTES);     // NS data tiles
    float* s_tot = s_data + NS * DATA_STAGE;                                // running totals
    uint64_t* full = reinterpret_cast<uint64_t*>(s_tot + ACC * THREADS);
    uint64_t* empty = full + NS;

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int kt = blockIdx.x % grid_k;
    const long long t0 = (long long)(blockIdx.x / grid_k) * BT;
    const long long k0 = (long long)kt * BK;
    const int n_stages = (int)((n_atoms + BA - 1) / BA);
    const int live = n_t < RESIDUES ? (int)n_t : RESIDUES;   // maps that hold a time step

    if (tid == 0) {
        for (int i = 0; i < NS; ++i) {
            mbar_init(&full[i], 1);              // lane 0 of warp 0 arrives, the copies complete
            mbar_init(&empty[i], THREADS / 32);  // every warp arrives
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // Lane 0 of warp 0 fills stage s into slot s % NS: the B tile, and per residue r
    // the box of time steps t0 + r, t0 + 4 + r, .. (u = t0 / 4 ..) and the
    // stage's floats from the 16-byte boundary below the first (a tensor
    // copy starts on one; up to 3 floats of the time step before lead), as
    // rows 16 r .. 16 r + 15 of the slot (time steps past n_t and floats
    // past the row's end come as zeros).
    const unsigned char* tiles = table + (size_t)kt * n_stages * STAGE_BYTES;
    auto fill = [&](int s) {
        const int slot = s % NS;
        mbar_arrive_expect_tx(&full[slot], STAGE_BYTES + live * BOX_ROWS * DATA_BOX * 4);
        bulk_copy(s_b + slot * STAGE_BYTES, tiles + (size_t)s * STAGE_BYTES, STAGE_BYTES,
                  &full[slot]);
        for (int r = 0; r < live; ++r)
            tensor_copy(s_data + slot * DATA_STAGE + r * BOX_ROWS * DATA_BOX, &maps.map[r],
                        (int)(3 * (r * row_atoms + atom0 + (long long)s * BA)) & ~3, (int)(t0 / 4),
                        &full[slot]);
    };
    if (tid == 0)
        for (int s = 0; s < NS && s < n_stages; ++s)
            fill(s);
    __syncwarp();

    // Warpgroup wg multiplies the rows of component c = wg; its warp wq the
    // time steps of residue wq: lane (g, tq) the A-fragment rows j = g and
    // g + 8, time steps 4 j + wq of the tile, slot rows 16 wq + j (their
    // floats 4 rows apart in the banks: the fragment loads meet no
    // conflict).  row_at[h] is this thread's first atom of a stage (tq for
    // TF32, 2 tq for BF16) in slot row 16 wq + g + 8 h, after the residue's
    // lead (the same in every stage: a stage is 96 floats).
    using T = Tier<TIER>;
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, tq = lane % 4;
    const int first_atom = tq * (T::KATOMS / 8);
    const int lead = (int)((3 * (wq * row_atoms + atom0)) & 3);
    int row_at[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        row_at[h] = (16 * wq + g + 8 * h) * DATA_BOX + lead + wg + 3 * first_atom;
    for (int i = 0; i < ACC; ++i)
        s_tot[i * THREADS + tid] = 0.0f;
    float acc[ACC], step[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i)
        acc[i] = 0.0f;
    const uint32_t b_base = smem_addr(s_b);
    const int tail = (int)(n_atoms - (long long)(n_stages - 1) * BA);   // atoms of the last stage

    constexpr int STAGES_PER_SUM = SUM_ATOMS / BA;
    for (int s = 0; s < n_stages; ++s) {
        // Warp 0 refills the slot of stage s - 1 with stage s + NS - 1 once
        // every warp is done with it: NS - 1 stages stay in flight.  Every
        // lane waits, lane 0 copies, and the warp is whole again before the
        // wgmma instructions, which each of its lanes must reach together.
        if (warp == 0 && s > 0 && s + NS - 1 < n_stages) {
            mbar_wait(&empty[(s - 1) % NS], ((s - 1) / NS) & 1);
            if (lane == 0)
                fill(s + NS - 1);
            __syncwarp();
        }
        const int slot = s % NS;
        mbar_wait(&full[slot], (s / NS) & 1);
        const float* sd = s_data + slot * DATA_STAGE;
        const uint32_t sb = b_base + slot * STAGE_BYTES;
        if (s + 1 < n_stages || tail == BA)
            stage_products<TIER, false>(sd, sb, row_at, BA, step, acc);
        else   // the atoms past the block's end hold other atoms' data: zero them
            stage_products<TIER, true>(sd, sb, row_at, tail - first_atom, step, acc);
        __syncwarp();
        if (lane == 0)
            mbar_arrive(&empty[slot]);
        if ((s + 1) % STAGES_PER_SUM == 0 || s + 1 == n_stages) {
#pragma unroll
            for (int i = 0; i < ACC; ++i) {
                s_tot[i * THREADS + tid] += acc[i];
                acc[i] = 0.0f;
            }
        }
    }

    // Accumulator 4 j + r: fragment row g + 8 (r / 2) of warp wq, i.e. time
    // step t0 + 4 (g + 8 (r / 2)) + wq and component wg; column
    // n = 8 j + 2 tq + r % 2: cos (n < BK) or sin of k-point n % BK.
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const long long t = t0 + 4 * (g + 8 * (r / 2)) + wq, m = 3 * t + wg;
            const int n = 8 * j + 2 * tq + r % 2;
            const long long k = k0 + n % BK;
            if (t < n_t && k < n_k) {
                float* out = (n < BK ? out_re : out_im) + m * n_k + k;
                const float tile = s_tot[(4 * j + r) * THREADS + tid];
                *out = accumulate ? *out + tile : tile;
            }
        }
}

long long n_stages_of(long long n_atoms) { return (n_atoms + BA - 1) / BA; }
long long grid_k_of(long long n_k) { return (n_k + BK - 1) / BK; }

// Bytes of the table of n_atoms atoms and n_k k-points: one STAGE_BYTES
// tile per (k-tile of BK, stage of BA atoms) (ops/sed_projection.py::table_bytes).
long long table_bytes_of(long long n_atoms, long long n_k)
{
    return grid_k_of(n_k) * n_stages_of(n_atoms) * STAGE_BYTES;
}

template <int TIER>
cudaError_t launch_table(const void* mp_hi, const void* mp_lo, const void* kv, void* table,
                         long long atom0, long long n_atoms, long long n_k, cudaStream_t stream)
{
    const long long n_stages = n_stages_of(n_atoms);
    tier_table_kernel<TIER><<<(unsigned)(n_stages * grid_k_of(n_k)), TABLE_THREADS, 0, stream>>>(
        (const float*)mp_hi, (const float*)mp_lo, (const float*)kv, (unsigned char*)table,
        atom0, n_atoms, n_k, (int)n_stages);
    return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* found = nullptr;
        cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &found, 12000,
                                                           cudaEnableDefault, &status);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found,
                                                  cudaEnableDefault, &status);
#endif
        if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(found);
    }
    return fn;
}

// The data's RESIDUES tensor maps (DataMaps), each with a (BOX_ROWS x
// DATA_BOX) box; false where the encoder is missing or refuses.
bool data_maps(DataMaps* maps, const void* data, long long n_t, long long row_atoms)
{
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr)
        return false;
    for (int r = 0; r < RESIDUES && r < n_t; ++r) {
        const cuuint64_t dims[2] = {(cuuint64_t)(3 * (r + 1) * row_atoms),
                                    (cuuint64_t)((n_t - r + RESIDUES - 1) / RESIDUES)};
        const cuuint64_t strides[1] = {(cuuint64_t)(3 * RESIDUES * row_atoms * sizeof(float))};
        const cuuint32_t box[2] = {DATA_BOX, BOX_ROWS}, steps[2] = {1, 1};
        if (encode(&maps->map[r], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(data),
                   dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return false;
    }
    return true;
}

template <int TIER>
cudaError_t launch_product(const DataMaps& maps, const void* table, void* out_re, void* out_im,
                           long long n_t, long long row_atoms, long long atom0, long long n_atoms,
                           long long n_k, int accumulate, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(tier_product_kernel<TIER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess)
        return err;
    const long long grid_t = (n_t + BT - 1) / BT, grid_k = grid_k_of(n_k);
    tier_product_kernel<TIER><<<(unsigned)(grid_t * grid_k), THREADS, SMEM_BYTES, stream>>>(
        maps, (const unsigned char*)table, (float*)out_re, (float*)out_im, n_t, row_atoms, atom0,
        n_atoms, n_k, (int)grid_k, accumulate);
    return cudaGetLastError();
}

}  // namespace

// The table of atoms atom0 .. atom0 + n_atoms at tier 1 ('balanced') or 2
// ('fast') into `table` (table_bytes long, 16-byte aligned).
extern "C" int psa_sed_tier_table(const void* mp_hi, const void* mp_lo, const void* kv,
                                  void* table, long long table_bytes, long long atom0,
                                  long long n_atoms, long long n_k, int tier, void* stream)
{
    if (n_atoms < 1 || n_k < 1 || atom0 < 0 || (tier != BALANCED && tier != FAST))
        return (int)cudaErrorInvalidValue;
    if (table_bytes < table_bytes_of(n_atoms, n_k))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(table) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    if (n_stages_of(n_atoms) * grid_k_of(n_k) > 2147483647LL)
        return (int)cudaErrorInvalidConfiguration;
    auto run = tier == BALANCED ? launch_table<BALANCED> : launch_table<FAST>;
    return (int)run(mp_hi, mp_lo, kv, table, atom0, n_atoms, n_k, (cudaStream_t)stream);
}

// out = (or +=, with accumulate) the projection of atoms atom0 .. atom0 +
// n_atoms of `data` ((n_t, row_atoms, 3) float32, 16-byte aligned) by the
// table of those atoms at tier 1 ('balanced') or 2 ('fast').
extern "C" int psa_sed_tier_product(const void* data, const void* table, long long table_bytes,
                                    void* out_re, void* out_im, long long n_t,
                                    long long row_atoms, long long atom0, long long n_atoms,
                                    long long n_k, int accumulate, int tier, void* stream)
{
    if (n_t < 1 || n_atoms < 1 || n_k < 1 || atom0 < 0 || atom0 + n_atoms > row_atoms
        || (tier != BALANCED && tier != FAST))
        return (int)cudaErrorInvalidValue;
    if (table_bytes < table_bytes_of(n_atoms, n_k))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(data) % 16 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    // the maps' coordinates are 32-bit: 12 row_atoms floats per row, n_t / 4 rows
    if (((n_t + BT - 1) / BT) * grid_k_of(n_k) > 2147483647LL || 3 * RESIDUES * row_atoms > 2147483647LL
        || n_t / RESIDUES > 2147483647LL)
        return (int)cudaErrorInvalidConfiguration;
    DataMaps maps = {};
    if (!data_maps(&maps, data, n_t, row_atoms))
        return (int)cudaErrorNotSupported;
    auto run = tier == BALANCED ? launch_product<BALANCED> : launch_product<FAST>;
    return (int)run(maps, table, out_re, out_im, n_t, row_atoms, atom0, n_atoms, n_k, accumulate,
                    (cudaStream_t)stream);
}

// Dynamic shared memory of one product block, in bytes (ptxas reports only static).
extern "C" int psa_sed_tier_product_smem_bytes()
{
    return SMEM_BYTES;
}
