// Fused phase generation + atom contraction of the SED, for Hopper (sm_90a):
// the 'parity' tier (3xTF32).
//
//   out_re[t, c, k] = sum_a data[t, a, c] * cos(A[a, k])
//   out_im[t, c, k] = sum_a data[t, a, c] * sin(A[a, k])
//   A[a, k]         = (mp_hi + mp_lo)[a] . kv[k], folded into [-pi, pi]
//
// Replaces the Pallas TPU kernel psa_tpu/ops/pallas_sed.py::sed_projection_pallas
// (body _projection_kernel, angle tile _angles_tile) at Precision.HIGHEST.  As
// there, the (A, 2K) phase table never reaches device memory.  The other
// tiers ('balanced', 'fast') run in sed_projection_tiers.cu: a table made once
// per call, then a wgmma product.
//
// As a matrix product: M = 3 n_t rows (t, c), N = 2K columns (cos | sin),
// depth A.  What bounds it, per working chunk (n_t, A, K) = (1e4, 1e5, 500):
//   * tensor work: 2 M N A = 6.0e12 flop per float32 product, 1.8e13 in the
//     3xTF32 form below: 36 ms at the card's 495 TFLOP/s dense TF32.
//   * angle tile: ceil(n_t / (CL BT)) * A * K = 4.0e9 evaluations (float64
//     dot and fold, float32 sincosf, TF32 split) at BT = 64 and CL = 2, on
//     the CUDA cores (7.9e9 when every time tile made its own).
//   * memory: the 12 GB trajectory is read from HBM about once: the
//     ceil(K / BK) = 16 k-tiles of one time tile run side by side and share
//     it through L2 (16 x 12 GB = 192 GB of L2 reads, where the PR 1 raster
//     read 8 x 12 GB from HBM).  Outputs: 0.12 GB.
//
// 3xTF32: each float32 operand x is split into big = cvt.rna.tf32(x) and
// small = cvt.rna.tf32(x - big), and d*c ~ d_small*c_big + d_big*c_small +
// d_big*c_big: three wgmma.m64n64k8 TF32 products per k-step of 8 atoms.
//
// Design:
//   * The tensor cores add to their float32 accumulator with truncation, so
//     the products of each CHAIN_ATOMS = 16 atoms start from zero and are
//     added to a register partial in IEEE float32; every SUM_ATOMS = 256
//     atoms the partial is added to a running total in shared memory.
//   * One block owns an output tile of BT = 64 time steps (BM = 192 rows) by
//     BK = 32 k-points (BN = 64 columns) and walks the whole atom axis
//     itself, BA = 32 atoms per stage.  No split of the atom axis, no
//     atomics: the sum order is fixed and results are identical from run to
//     run.
//   * Clusters.  The angle tile of a stage does not depend on time, so the
//     blocks run as thread-block clusters of CL blocks that share one k-tile
//     and own CL consecutive time tiles.  The block of cluster rank r makes
//     the angles of the stage's atoms r BA / CL to (r + 1) BA / CL - 1 for
//     all BK k-points, a contiguous share of SHARE_BYTES in the angle tile's
//     layout, into its own slot; then one maker sends that share to the same
//     place in every other block of the cluster with one TMA bulk copy
//     through distributed shared memory (cp.async.bulk.shared::cluster),
//     which completes on the receiving block's FULL barrier of the slot.
//     The ceil(n_t / BT) * A * K evaluations fall to ceil(n_t / (CL BT)) * A
//     * K.  The time tiles are padded up to a multiple of CL; a block whose
//     tile lies wholly past n_t still makes and sends its share and keeps
//     the barriers, and copies, multiplies and stores nothing.
//   * Warp roles.  3 MMA warpgroups (64 rows each) multiply: A, the data,
//     from registers (loaded from shared memory and split there), B, the
//     angle tile, from shared memory.  8 maker warps fill a ring of NS = 4
//     stages: they copy each stage's data tile with cp.async, AHEAD = 2
//     stages before its use, and make their block's share of its angle
//     tile: the stage's positions turned into float64 once, into shared
//     memory, float64 dot and fold (the card has native FP64, so the TPU's
//     double-single arithmetic, which nvcc's FMA contraction would break, is
//     not used), the accurate sincosf (this file must not be built with
//     --use_fast_math), the TF32 split, written as K-major core matrices for
//     wgmma.
//   * Hand-over: mbarriers in each block's shared memory, FULL and EMPTY per
//     slot.  FULL[slot] completes when one lane of each of the block's maker
//     warps has arrived (after its stores and its data copies landed), one
//     of them also expecting the (CL - 1) SHARE_BYTES of the other blocks'
//     shares, and those bytes have come.  EMPTY[slot] completes when every
//     MMA warp of every block of the cluster has arrived (a remote arrive
//     for the others): only then may a block's makers copy data into the
//     slot or send a share into it, anywhere in the cluster, and the bulk
//     copies of the slot's last stage have been read.  The proxy fence: the
//     makers write their share through the generic proxy, and both this
//     block's wgmma and the TMA unit that sends it read it through the async
//     proxy; so each maker thread issues fence.proxy.async.shared::cta after
//     its stores, before the makers' barrier after which maker 0 sends the
//     share and before its warp's arrive on FULL.  The peers' shares are
//     written by the TMA unit, in the async proxy, and made visible by the
//     FULL barrier's completion, as any TMA load.  Nothing here is a
//     generic write into another block, so no fence or release needs
//     cluster scope (measured: such stores with cluster-scope
//     release/acquire arrivals made the kernel 1.7x slower).  No block leaves
//     before the cluster's last barrier.
//   * The data tile keeps the natural (n_t, A, 3) layout: per time step one
//     row of the stage's 3*BA floats, copied in 16-byte pieces from the
//     16-byte boundary below (a row of 3A floats is 16-byte aligned only
//     when A % 4 == 0; the data pointer must be).  Ragged n_t, A and K are
//     masked: bytes past a time step's end are zero-filled by cp.async,
//     missing angles are zero, and stores are guarded.  Callers pad nothing.
//   * Raster: cluster c takes k-tile c % grid_k and time tiles
//     (c / grid_k) CL + rank; the k-tile index is fastest, so the blocks in
//     flight share few time tiles and their data tiles come from L2.  The
//     clusters go in launches of WAVES times as many as the card holds at
//     once (cluster0 is a launch's first): within a launch they start
//     together and keep close, so the readers of a time tile read it at
//     about the same time.  In one launch of the whole grid each cluster
//     starts when another ends, start times spread evenly, and a time
//     tile's readers, spread over grid_k / 66 block lengths (twice the
//     spread without clusters, 132 blocks at once), miss L2 at large A.
//
// Measured on an NVIDIA H100 80GB HBM3, 700 W power limit, at the working
// chunk.  Before the clusters: ~97 ms against ~130 ms for the plain table +
// cuBLAS path and 267.673 ms for the first version of this kernel; the MMA
// warpgroups alone took ~64 ms and the makers alone ~70 ms, and the makers
// set the pace.  With clusters of 2 in one launch: 92.5-94.5 ms against
// 96.8-98.6 ms without, timed in turns in one process; the makers alone
// take ~47 ms and the MMA warpgroups alone ~58 ms, so the MMA side (its
// fragment loads and splits, the chained sums and the wgmma waits) now sets
// the pace, and the two roles share the SMs' issue slots and the card's
// 700 W.  But at A = 2.5e5 atoms that took 0.4-2.2% more than without
// clusters.  In launches of 4 waves: 94.751 ms against 97.501 at the working
// chunk (2.8-3.9% less) and 6.3% less at (n_t, A, K) = (2e4, 2.5e5, 2500)
// (16 waves: 3.8% and 5.7%).  Clusters of 4 (30 of them fit at once: 120 of
// the 132 SMs) took 104-108 ms.  Error against a float64 sum of the same
// float32 operands, first 8 k-columns, as a fraction of max|sum|: 7.9e-7
// (plain cuBLAS float32: 4.2e-6).  With mma.sync in place of wgmma the same design took 134 ms.
// The clusters change no arithmetic: every output is bit for bit that of the
// kernel without them.
//
// Output: the kernel writes out_re/out_im, or with accumulate != 0 adds its
// sums to them (out += tile, one extra read of the output tile after the
// two-level sum).  An atom axis streamed in blocks accumulates into one
// output this way, and a time axis streamed in blocks writes row slices of
// one output (each is a contiguous (rows, 3, n_k) array).
//
// Entry point psa_sed_projection launches on the given stream, does not
// synchronise, allocates nothing, and returns the first CUDA error (0 if
// none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;                    // time steps per block
constexpr int BM = 3 * BT;                // output rows (t, c) per block: 192
constexpr int BK = 32;                    // k-points per block
constexpr int BN = 2 * BK;                // MMA columns per block (cos | sin): 64
constexpr int BA = 32;                    // atoms per pipeline stage
constexpr int CL = 2;                     // blocks per cluster: time tiles that share an angle tile
constexpr int WAVES = 4;                  // waves of clusters per launch
constexpr int NS = 4;                     // stages in the shared-memory ring
constexpr int AHEAD = 2;                  // stages a data copy is issued ahead of its use
constexpr int SUM_ATOMS = 256;            // atoms per fresh partial sum
constexpr int CHAIN_ATOMS = 16;           // atoms per fresh MMA sum, then added in IEEE float32
constexpr int KATOMS = 8;                 // atoms per m64n64k8 k-step
constexpr int KSTEPS = BA / KATOMS;       // k-steps per stage
constexpr int CHAIN = CHAIN_ATOMS / KATOMS;   // k-steps per fresh MMA sum
constexpr int MMA_THREADS = 128 * (BM / 64);   // one warpgroup per 64 rows: 384
constexpr int MMA_WARPS = MMA_THREADS / 32;    // 12
constexpr int MAKER_WARPS = 8;            // warps that copy data and make angles
constexpr int MAKER_THREADS = 32 * MAKER_WARPS;       // 256
constexpr int THREADS = MMA_THREADS + MAKER_THREADS;  // 640
constexpr int ANGLES = BA * BK / (CL * MAKER_THREADS);   // angles per maker thread and stage: 2
constexpr int ACC = BN / 2;               // accumulators per MMA thread (m64n64): 32
constexpr int ROW_FLOATS = 3 * BA;        // contiguous floats per time step and stage: 96
constexpr int CHUNKS = ROW_FLOATS / 4 + 1; // 16-byte copies per row, aligned down: 25
constexpr int DATA_PITCH = 4 * CHUNKS + 4; // floats per row in shared memory: 104
constexpr int DATA_STAGE = BT * DATA_PITCH;   // floats of one data tile: 6656
constexpr int PIECES = (BT * CHUNKS + MAKER_THREADS - 1) / MAKER_THREADS;  // per maker: 7
constexpr int B_STAGE = 2 * BA * BN;      // floats of one angle tile, big + small TF32: 4096
constexpr int BAR_OFFSET = (BK * 3 + 2 * ROW_FLOATS) * (int)sizeof(double)
    + (ACC * MMA_THREADS + NS * (DATA_STAGE + B_STAGE)) * (int)sizeof(float);
constexpr int SMEM_BYTES = BAR_OFFSET + 2 * NS * (int)sizeof(uint64_t);   // + FULL, EMPTY
// Named barrier 1: the maker warps among themselves (0 is __syncthreads()).
constexpr int MAKERS = 1;

static_assert(BM % 64 == 0 && BN == 64, "m64n64k8 warpgroup tiles");
static_assert(SUM_ATOMS % BA == 0, "partials restart on stage boundaries");
static_assert(BA % CHAIN_ATOMS == 0 && CHAIN_ATOMS % KATOMS == 0, "MMA sums within a stage");
static_assert(ANGLES * CL * MAKER_THREADS == BA * BK && BK == 32 && BA % (4 * CL) == 0 && CL <= 8,
              "equal shares of whole 4-atom groups, four 8-k-point groups; a portable cluster");
static_assert(ROW_FLOATS <= MAKER_THREADS, "position makers");
static_assert(AHEAD + 2 <= NS, "the makers run up to NS - AHEAD stages ahead of the MMA warps");
static_assert(BAR_OFFSET % 8 == 0 && SMEM_BYTES <= 232448, "mbarriers; H100 shared memory per block");

constexpr double TWO_PI = 6.283185307179586476925286766559;
constexpr double INV_TWO_PI = 0.15915494309189533576888376337251;

// The 3xTF32 split of a finite float: big = cvt.rna.tf32(x) (add 0x1000 to
// the bits, clear the low 13); small is x - big with 0x1000 added to its
// bits, which the tensor cores, reading only the top 19 bits, take as
// cvt.rna.tf32(x - big).  Four instructions, where nvcc lowers one
// cvt.rna.tf32 alone to four.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small)
{
    big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// Shared-memory matrix descriptor, no swizzle: start address, then the byte
// offsets between core matrices (8 rows x 16 bytes) along K (LBO) and
// along N (SBO), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

// d = a * b (+ d if accumulate) for one warpgroup: m64n64k8, TF32 inputs,
// float32 accumulators; a from registers (the m16n8k8 A fragment of each
// warp's 16 rows), b from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// One k-step's product into d (from zero unless accumulate): the small
// terms first, so the truncating accumulator adds the big one last.
__device__ __forceinline__ void mma_step(float (&d)[ACC], const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4], uint64_t b_big,
                                         uint64_t b_small, int accumulate)
{
    wgmma_tf32(d, a_small, b_big, accumulate);
    wgmma_tf32(d, a_big, b_small, 1);
    wgmma_tf32(d, a_big, b_big, 1);
}

// The A fragment of one k-step from the data tile: r0 and r1 point at the
// k-step's first atom of this thread in rows g and g + 8: atoms tq and
// tq + 4 (floats 0 and 12 on).
__device__ __forceinline__ void load_a(const float* r0, const float* r1, uint32_t (&big)[4],
                                       uint32_t (&small)[4])
{
    split_tf32(r0[0], big[0], small[0]);
    split_tf32(r1[0], big[1], small[1]);
    split_tf32(r0[12], big[2], small[2]);
    split_tf32(r1[12], big[3], small[3]);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n\twgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Copy `bytes` (0 to 16) of 16 from global to shared memory; the rest is zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until this thread's copies of all but the newest AHEAD groups landed.
__device__ __forceinline__ void cp_async_wait_ahead()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(AHEAD) : "memory");
}

__device__ __forceinline__ void bar_sync_makers()
{
    asm volatile("bar.sync %0, %1;" :: "n"(MAKERS), "n"(MAKER_THREADS) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of this block's shared-memory address `addr`
// in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank)
{
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar)) : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrive on the mbarrier at shared::cluster address `bar`, this block's or
// a peer's.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity)
{
    asm volatile("{\n.reg .pred done;\nWAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "@!done bra WAIT;\n}" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Copy `bytes` (a multiple of 16) of this block's shared memory to
// shared::cluster address `dst` by the TMA unit, completing on the
// mbarrier at shared::cluster address `bar` (both in the destination block).
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar)
{
    asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 :: "r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(bar) : "memory");
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync()
{
    asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// Data tile layout: time row tl of a stage holds the stage's 3*BA floats of
// that time step, from float (t * 3A) % 4 of the row on (the copies are
// aligned down to 16 bytes); rows are DATA_PITCH floats apart, which leaves
// at most two-way bank conflicts on the fragment loads.

// Angle tile layout: K-major core matrices for the wgmma B operand.  Column
// n < BK holds cos and n >= BK sin of k-point n % BK; per k-step ks, group
// of 4 atoms a / 4 and part (big, small) a row of 8 core matrices, each 8
// columns x 16 bytes (4 TF32 atoms): atom a = al % KATOMS of k-step
// al / KATOMS at
//   byte ((((ks * 2 + a / 4) * 2 + part) * 8 + n / 8) * 128 + (n % 8) * 16 + (a % 4) * 4.
// A stage fills B_STAGE floats (4 k-steps x 2 parts); its atoms run in order
// through the bytes, so the share of cluster rank r, atoms r BA / CL on, is
// one block of SHARE_BYTES at r SHARE_BYTES.
constexpr uint32_t CORE_N_STEP = 128;         // next 8 columns (SBO)
constexpr uint32_t PART_BYTES = 8 * 128;      // a row of core matrices: 4 atoms, big or small
constexpr uint32_t CORE_K_STEP = 2 * PART_BYTES;   // next 16 bytes of atoms (LBO)
constexpr uint32_t K_STEP_BYTES = 2 * CORE_K_STEP; // one k-step, both parts
constexpr uint32_t SHARE_BYTES = B_STAGE * sizeof(float) / CL;   // one block's share of a stage
static_assert(KSTEPS % CL == 0 && SHARE_BYTES % 16 == 0, "whole k-steps per share; bulk copies");

__device__ __forceinline__ uint32_t b_byte(int al, int n)
{
    const int ks = al / KATOMS, a = al % KATOMS;
    return (((ks * 2 + a / 4) * 2) * 8 + n / 8) * 128 + (n % 8) * 16 + (a % 4) * 4;
}

// Write one angle-tile value x (cos or sin, 0 where masked) at byte `at`
// of part big, split in 3xTF32 form; the small part follows PART_BYTES later.
__device__ __forceinline__ void store_b(unsigned char* at, float x)
{
    uint32_t big, small;
    split_tf32(x, big, small);
    *reinterpret_cast<uint32_t*>(at) = big;
    *reinterpret_cast<uint32_t*>(at + PART_BYTES) = small;
}

__global__ void __launch_bounds__(THREADS, 1)
sed_projection_kernel(const float* __restrict__ data,
                      const float* __restrict__ mp_hi,
                      const float* __restrict__ mp_lo,
                      const float* __restrict__ kv,
                      float* __restrict__ out_re,
                      float* __restrict__ out_im,
                      long long n_t, long long n_atoms, long long n_k,
                      int grid_k, int accumulate, long long cluster0)
{
    extern __shared__ __align__(16) unsigned char smem[];
    double* s_k = reinterpret_cast<double*>(smem);
    double* s_pos = s_k + BK * 3;   // two stages of (mp_hi + mp_lo) in float64
    float* s_tot = reinterpret_cast<float*>(s_pos + 2 * ROW_FLOATS);
    float* s_data = s_tot + ACC * MMA_THREADS;
    float* s_b = s_data + NS * DATA_STAGE;
    uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
    uint64_t* s_empty = s_full + NS;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, tq = lane % 4;
    const int rank = (int)(blockIdx.x % CL);          // the block's rank in its cluster
    const long long cluster = cluster0 + blockIdx.x / CL;
    const long long k0 = (cluster % grid_k) * BK;
    const long long t0 = ((cluster / grid_k) * CL + rank) * BT;
    const bool live = t0 < n_t;                       // false: a padded time tile
    const long long row_stride = n_atoms * 3;     // floats per time step
    const int n_stages = (int)((n_atoms + BA - 1) / BA);

    for (int i = tid; i < BK * 3; i += THREADS) {
        const long long k = k0 + i / 3;
        s_k[i] = k < n_k ? (double)kv[k * 3 + i % 3] : 0.0;
    }
    if (tid == 0) {
        for (int i = 0; i < NS; ++i) {
            mbar_init(&s_full[i], MAKER_WARPS);
            mbar_init(&s_empty[i], MMA_WARPS * CL);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();   // s_k, and every block's barriers before any peer arrives on them

    if (tid >= MMA_THREADS) {
        // ---- makers: copy each stage's data tile and make its angle tile ----
        const int mtid = tid - MMA_THREADS, mwarp = warp - MMA_THREADS / 32;

        // Copies: BT rows of CHUNKS 16-byte pieces per stage, from the stage's
        // first float of the time step aligned down to 16 bytes; bytes past
        // the end of the time step, or of a time step past n_t, are
        // zero-filled.  Maker mtid copies pieces i = mtid + MAKER_THREADS r:
        // their place in the slot, first float in stage 0, time step's end.
        uint32_t piece_dst[PIECES];
        long long piece_src[PIECES], piece_end[PIECES];
#pragma unroll
        for (int r = 0; r < PIECES; ++r) {
            const int i = mtid + MAKER_THREADS * r, tl = i / CHUNKS, c = i % CHUNKS;
            const long long row = (t0 + tl) * row_stride;
            piece_dst[r] = smem_addr(s_data + tl * DATA_PITCH + 4 * c);
            piece_src[r] = row - (row & 3) + 4 * c;
            piece_end[r] = t0 + tl < n_t ? row + row_stride : 0;
        }
        auto copy_data = [&](int s) {
            if (s >= n_stages || !live)
                return;
            const uint32_t base = (s % NS) * DATA_STAGE * sizeof(float);
            if (s + 2 < n_stages && t0 + BT <= n_t) {   // every piece lies inside its time step
#pragma unroll
                for (int r = 0; r < PIECES; ++r)
                    if (mtid + MAKER_THREADS * r < BT * CHUNKS)
                        cp_async16(piece_dst[r] + base, data + piece_src[r] + (long long)s * ROW_FLOATS);
                return;
            }
#pragma unroll
            for (int r = 0; r < PIECES; ++r) {
                const long long idx = piece_src[r] + (long long)s * ROW_FLOATS;
                const long long left = piece_end[r] - idx;
                const int n = left <= 0 ? 0 : left >= 4 ? 4 : (int)left;
                if (mtid + MAKER_THREADS * r < BT * CHUNKS)
                    cp_async16(piece_dst[r] + base, n ? data + idx : data, n * (int)sizeof(float));
            }
        };

        // Makers of cluster rank `rank` make the stage's atoms rank BA / CL on,
        // BA / CL of them, for all BK k-points: thread (mwarp, g, tq) makes
        // pairs p = mwarp + MAKER_WARPS u (u < ANGLES) of atom
        // rank BA / CL + 4 (p / 4) + tq and k-point 8 (p % 4) + g.  Makers
        // mtid < ROW_FLOATS turn one float of the stage's positions into
        // float64 for all; they read it a stage ahead, so its latency hides
        // behind a stage of work.
        float hi_next = 0.0f, lo_next = 0.0f;
        auto read_position = [&](int s) {
            const long long o = (long long)s * ROW_FLOATS + mtid;
            const bool ok = mtid < ROW_FLOATS && o < row_stride;
            hi_next = ok ? mp_hi[o] : 0.0f;
            lo_next = ok ? mp_lo[o] : 0.0f;
        };
        // Maker 0 sends this block's share of stage s's angle tile to the
        // same place in every other block of the cluster, by the TMA unit,
        // completing on that block's FULL barrier of the slot.
        auto send_share = [&](int s) {
            if (mtid != 0)
                return;
            const uint32_t at = (s % NS) * B_STAGE * sizeof(float) + rank * SHARE_BYTES;
            const uint32_t bar = smem_addr(s_full + s % NS);
            for (int d = 1; d < CL; ++d) {
                const int q = (rank + d) % CL;
                bulk_copy_peer(peer_addr(smem_addr(s_b) + at, q),
                               reinterpret_cast<unsigned char*>(s_b) + at, SHARE_BYTES,
                               peer_addr(bar, q));
            }
        };
        read_position(0);
        if (mtid < ROW_FLOATS)
            s_pos[mtid] = (double)hi_next + (double)lo_next;
        read_position(1);
        for (int s = 0; s < AHEAD; ++s) {
            copy_data(s);
            cp_async_commit();
        }
        bar_sync_makers();   // stage 0's positions

        // Stage s: wait until every block's MMA warps are done with stage
        // s + AHEAD - NS, whose slot the copy of stage s + AHEAD takes (stage
        // s's angle tile takes the slot of stage s - NS, waited for AHEAD
        // stages ago, in every block); make this block's share of stage s's
        // angles while that copy and the one of stage s + 1 are in flight.
        for (int s = 0; s < n_stages; ++s) {
            const int buf = s % NS;
            if (s >= NS - AHEAD) {
                const int u = s + AHEAD - NS;
                mbar_wait(&s_empty[u % NS], (u / NS) & 1);
            }
            copy_data(s + AHEAD);
            cp_async_commit();

            const double* sp = s_pos + (s & 1) * ROW_FLOATS;
            // The angles first, without branches, so their latencies overlap;
            // a pair out of range takes angle 0 and is zeroed after.
            float ang32[ANGLES];
            bool ok[ANGLES];
#pragma unroll
            for (int u = 0; u < ANGLES; ++u) {
                const int p = mwarp + MAKER_WARPS * u;
                const int al = rank * (BA / CL) + 4 * (p / 4) + tq, kl = 8 * (p % 4) + g;
                double pos[3];
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    pos[d] = sp[3 * al + d];
                double ang = pos[0] * s_k[3 * kl] + pos[1] * s_k[3 * kl + 1]
                           + pos[2] * s_k[3 * kl + 2];
                ang -= TWO_PI * rint(ang * INV_TWO_PI);
                ok[u] = (long long)s * BA + al < n_atoms && k0 + kl < n_k;
                ang32[u] = ok[u] ? (float)ang : 0.0f;
            }
            // Atom al, column kl (cos) and BK + kl (sin).
            unsigned char* sb = reinterpret_cast<unsigned char*>(s_b + buf * B_STAGE);
#pragma unroll
            for (int u = 0; u < ANGLES; ++u) {
                const int p = mwarp + MAKER_WARPS * u;
                const int al = rank * (BA / CL) + 4 * (p / 4) + tq, kl = 8 * (p % 4) + g;
                float cs, sn;
                sincosf(ang32[u], &sn, &cs);
                store_b(sb + b_byte(al, kl), ok[u] ? cs : 0.0f);
                store_b(sb + b_byte(al, kl + BK), ok[u] ? sn : 0.0f);
            }
            // This block's MMA warps and its TMA unit, which sends the share
            // to the other blocks, read the angle tile through the async proxy.
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            if (mtid < ROW_FLOATS && s + 1 < n_stages)   // the other buffer: read last stage
                s_pos[((s + 1) & 1) * ROW_FLOATS + mtid] = (double)hi_next + (double)lo_next;
            if (s + 2 < n_stages)
                read_position(s + 2);
            bar_sync_makers();   // stage s's share is whole, stage s + 1's positions are in
            send_share(s);
            cp_async_wait_ahead();
            __syncwarp();
            if (lane == 0) {
                if (mwarp == 0)   // the other blocks' shares come as bytes of copies
                    mbar_arrive_expect_tx(&s_full[buf], (CL - 1) * SHARE_BYTES);
                else
                    mbar_arrive(&s_full[buf]);
            }
        }
    } else {
        // ---- MMA warpgroups: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
        const int wg = warp / 4, wq = warp % 4;
        // Rows 64 wg + 16 wq + g + 8 h of the A fragments: (time tl, component
        // c).  row_at[h] is where this thread's first atom of the stage (tq)
        // sits in that row.
        int row_at[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = 64 * wg + 16 * wq + g + 8 * h, tl = m / 3;
            row_at[h] = tl * DATA_PITCH + (int)(((t0 + tl) * row_stride) & 3) + m % 3 + 3 * tq;
        }
        for (int i = 0; i < ACC; ++i)
            s_tot[i * MMA_THREADS + tid] = 0.0f;
        float acc[ACC], step[ACC];
#pragma unroll
        for (int i = 0; i < ACC; ++i)
            acc[i] = 0.0f;
        const uint32_t b_base = smem_addr(s_b);
        uint32_t empty_at[CL];   // s_empty of each block of the cluster
#pragma unroll
        for (int q = 0; q < CL; ++q)
            empty_at[q] = peer_addr(smem_addr(s_empty), q);

        constexpr int STAGES_PER_SUM = SUM_ATOMS / BA;
        for (int s = 0; s < n_stages; ++s) {
            const int buf = s % NS;
            mbar_wait(&s_full[buf], (s / NS) & 1);
            if (live) {
                const float* sd = s_data + buf * DATA_STAGE;
                const uint32_t sb = b_base + buf * B_STAGE * sizeof(float);
#pragma unroll
                for (int k0s = 0; k0s < KSTEPS; k0s += CHAIN) {
                    uint32_t a_big[CHAIN][4], a_small[CHAIN][4];
#pragma unroll
                    for (int q = 0; q < CHAIN; ++q)
                        load_a(sd + row_at[0] + 3 * KATOMS * (k0s + q),
                               sd + row_at[1] + 3 * KATOMS * (k0s + q), a_big[q], a_small[q]);
                    // The tensor cores truncate when they add to the
                    // accumulator, so each MMA sum covers only CHAIN_ATOMS
                    // atoms, from zero, and is added in IEEE float32.
                    wgmma_fence();
#pragma unroll
                    for (int q = 0; q < CHAIN; ++q) {
                        const uint32_t b = sb + (k0s + q) * K_STEP_BYTES;
                        const uint64_t b_big = smem_desc(b, CORE_K_STEP, CORE_N_STEP);
                        const uint64_t b_small = smem_desc(b + PART_BYTES, CORE_K_STEP, CORE_N_STEP);
                        mma_step(step, a_big[q], a_small[q], b_big, b_small, q > 0);
                    }
                    wgmma_commit_wait();
#pragma unroll
                    for (int i = 0; i < ACC; ++i)
                        acc[i] += step[i];
                }
            }
            if (s < n_stages - (NS - AHEAD)) {   // the makers of every block wait for this stage
                __syncwarp();
                if (lane == 0) {
#pragma unroll
                    for (int q = 0; q < CL; ++q)
                        mbar_arrive_at(empty_at[q] + buf * (int)sizeof(uint64_t));
                }
            }

            if ((s + 1) % STAGES_PER_SUM == 0 || s + 1 == n_stages) {
#pragma unroll
                for (int i = 0; i < ACC; ++i) {
                    s_tot[i * MMA_THREADS + tid] += acc[i];
                    acc[i] = 0.0f;
                }
            }
        }

        // Accumulator 4 j + r: row 64 wg + 16 wq + g + 8 (r / 2), column
        // n = 8 j + 2 tq + r % 2: cos (n < BK) or sin of k-point n % BK.
        const long long n_rows = n_t * 3;
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const long long m = t0 * 3 + 64 * wg + 16 * wq + g + 8 * (r / 2);
                const int n = 8 * j + 2 * tq + r % 2;
                const long long k = k0 + n % BK;
                if (m < n_rows && k < n_k) {
                    float* out = (n < BK ? out_re : out_im) + m * n_k + k;
                    const float tile = s_tot[(4 * j + r) * MMA_THREADS + tid];
                    *out = accumulate ? *out + tile : tile;
                }
            }
    }
    cluster_sync();   // no peer writes into, or arrives on, a block that has left
}

cudaError_t set_smem()
{
    return cudaFuncSetAttribute(sed_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_BYTES);
}

// Launch configuration of `blocks` blocks (a multiple of CL) in clusters of CL.
struct ClusterLaunch {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;

    ClusterLaunch(long long blocks, cudaStream_t stream)
    {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = CL;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        config = cudaLaunchConfig_t{};
        config.gridDim = dim3((unsigned)blocks);
        config.blockDim = dim3(THREADS);
        config.dynamicSmemBytes = SMEM_BYTES;
        config.stream = stream;
        config.attrs = attr;
        config.numAttrs = 1;
    }
};

// Clusters of the kernel that the current device holds at once.
cudaError_t active_clusters(int* clusters)
{
    cudaError_t err = set_smem();
    if (err != cudaSuccess)
        return err;
    const ClusterLaunch one(CL, 0);
    return cudaOccupancyMaxActiveClusters(clusters, sed_projection_kernel, &one.config);
}

// The n_clusters clusters (time tiles padded to whole clusters) in launches
// of WAVES times the clusters the card holds at once (Raster, above).
cudaError_t launch(const void* data, const void* mp_hi, const void* mp_lo, const void* kv,
                   void* out_re, void* out_im, long long n_t, long long n_atoms,
                   long long n_k, long long n_clusters, long long grid_k, int accumulate,
                   cudaStream_t stream)
{
    int clusters = 0;
    cudaError_t err = active_clusters(&clusters);
    if (err != cudaSuccess)
        return err;
    const long long per_launch = (long long)WAVES * (clusters > 0 ? clusters : 1);
    for (long long c0 = 0; c0 < n_clusters; c0 += per_launch) {
        const long long n = n_clusters - c0 < per_launch ? n_clusters - c0 : per_launch;
        const ClusterLaunch cl(n * CL, stream);
        err = cudaLaunchKernelEx(&cl.config, sed_projection_kernel,
                                 (const float*)data, (const float*)mp_hi, (const float*)mp_lo,
                                 (const float*)kv, (float*)out_re, (float*)out_im, n_t, n_atoms,
                                 n_k, (int)grid_k, accumulate, c0);
        if (err != cudaSuccess)
            return err;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int psa_sed_projection(const void* data, const void* mp_hi,
                                  const void* mp_lo, const void* kv,
                                  void* out_re, void* out_im,
                                  long long n_t, long long n_atoms,
                                  long long n_k, int accumulate, void* stream)
{
    if (n_t < 1 || n_atoms < 1 || n_k < 1)
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(data) % 16 != 0)   // the 16-byte copies need it
        return (int)cudaErrorMisalignedAddress;
    // Time tiles padded up to whole clusters.
    const long long grid_t = ((n_t + BT - 1) / BT + CL - 1) / CL * CL;
    const long long grid_k = (n_k + BK - 1) / BK;
    if (grid_t * grid_k > 2147483647LL || (n_atoms + BA - 1) / BA > 2147483647LL)
        return (int)cudaErrorInvalidConfiguration;
    return (int)launch(data, mp_hi, mp_lo, kv, out_re, out_im, n_t, n_atoms, n_k,
                       grid_t / CL * grid_k, grid_k, accumulate, (cudaStream_t)stream);
}

// Clusters of the kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int psa_sed_projection_active_clusters()
{
    int clusters = 0;
    const cudaError_t err = active_clusters(&clusters);
    return err == cudaSuccess ? clusters : -(int)err;
}

// Dynamic shared memory of one block, in bytes (ptxas reports only static).
extern "C" int psa_sed_projection_smem_bytes()
{
    return SMEM_BYTES;
}
