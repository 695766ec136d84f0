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
//   * angle tile: ceil(n_t / BT) * A * K = 7.9e9 evaluations (float64 dot
//     and fold, float32 sincosf, TF32 split) at BT = 64, on the CUDA cores.
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
//   * Warp roles.  3 MMA warpgroups (64 rows each) multiply: A, the data,
//     from registers (loaded from shared memory and split there), B, the
//     angle tile, from shared memory.  8 maker warps fill a ring of NS = 4
//     stages: they copy each stage's data tile with cp.async, AHEAD = 2
//     stages before its use, and make its angle tile: the stage's positions
//     turned into float64 once, into shared memory, float64 dot and fold
//     (the card has native FP64, so the TPU's double-single arithmetic,
//     which nvcc's FMA contraction would break, is not used), the accurate
//     sincosf (this file must not be built with --use_fast_math), the
//     TF32 split, written as K-major core matrices for wgmma.  Named barriers
//     (FULL, EMPTY per slot) hand the slots over, so the angle work and the
//     copies overlap the MMAs.
//   * The data tile keeps the natural (n_t, A, 3) layout: per time step one
//     row of the stage's 3*BA floats, copied in 16-byte pieces from the
//     16-byte boundary below (a row of 3A floats is 16-byte aligned only
//     when A % 4 == 0; the data pointer must be).  Ragged n_t, A and K are
//     masked: bytes past a time step's end are zero-filled by cp.async,
//     missing angles are zero, and stores are guarded.  Callers pad nothing.
//   * Raster: the k-tile index is fastest, so the blocks in flight share few
//     time tiles and their data tiles come from L2.
//
// Measured on an NVIDIA H100 80GB HBM3, 700 W power limit, at the working
// chunk: ~97 ms (97.3-97.9 with the other tiers moved out, bit for bit the
// same outputs) against ~130 ms for the plain table + cuBLAS path and
// 267.673 ms for the PR 1 kernel; the MMA warpgroups alone take ~62 ms, so
// the makers' angle work (float64 math, sincosf) and copies, sharing the
// SMs' issue slots, set the pace.  Error against a float64 sum of the same
// float32 operands, first 8 k-columns, as a fraction of max|sum|: 7.9e-7
// (plain cuBLAS float32: 4.2e-6).  With mma.sync in place of wgmma the same
// design took 134 ms.
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
constexpr int NS = 4;                     // stages in the shared-memory ring
constexpr int AHEAD = 2;                  // stages a data copy is issued ahead of its use
constexpr int SUM_ATOMS = 256;            // atoms per fresh partial sum
constexpr int CHAIN_ATOMS = 16;           // atoms per fresh MMA sum, then added in IEEE float32
constexpr int KATOMS = 8;                 // atoms per m64n64k8 k-step
constexpr int KSTEPS = BA / KATOMS;       // k-steps per stage
constexpr int CHAIN = CHAIN_ATOMS / KATOMS;   // k-steps per fresh MMA sum
constexpr int MMA_THREADS = 128 * (BM / 64);   // one warpgroup per 64 rows: 384
constexpr int MAKER_WARPS = 8;            // warps that copy data and make angles
constexpr int MAKER_THREADS = 32 * MAKER_WARPS;       // 256
constexpr int THREADS = MMA_THREADS + MAKER_THREADS;  // 640
constexpr int GROUPS8 = BA / 8;           // 8-atom groups per stage, one per maker warp pair
constexpr int ACC = BN / 2;               // accumulators per MMA thread (m64n64): 32
constexpr int ROW_FLOATS = 3 * BA;        // contiguous floats per time step and stage: 96
constexpr int CHUNKS = ROW_FLOATS / 4 + 1; // 16-byte copies per row, aligned down: 25
constexpr int DATA_PITCH = 4 * CHUNKS + 4; // floats per row in shared memory: 104
constexpr int DATA_STAGE = BT * DATA_PITCH;   // floats of one data tile: 6656
constexpr int PIECES = (BT * CHUNKS + MAKER_THREADS - 1) / MAKER_THREADS;  // per maker: 7
constexpr int B_STAGE = 2 * BA * BN;      // floats of one angle tile, big + small TF32: 4096
constexpr int SMEM_BYTES = (BK * 3 + 2 * ROW_FLOATS) * (int)sizeof(double)
    + (ACC * MMA_THREADS + NS * (DATA_STAGE + B_STAGE)) * (int)sizeof(float);
// Named barriers: FULL + slot (the makers filled it), EMPTY + slot (the MMA
// warps are done with it); 0 is __syncthreads().
constexpr int FULL = 1;
constexpr int EMPTY = FULL + NS;
constexpr int MAKERS = EMPTY + NS;        // the maker warps among themselves

static_assert(BM % 64 == 0 && BN == 64, "m64n64k8 warpgroup tiles");
static_assert(SUM_ATOMS % BA == 0, "partials restart on stage boundaries");
static_assert(BA % CHAIN_ATOMS == 0 && CHAIN_ATOMS % KATOMS == 0, "MMA sums within a stage");
static_assert(MAKER_WARPS * 16 == GROUPS8 * BK, "one maker warp per (8 atoms, 16 k-points)");
static_assert(MAKERS < 16 && ROW_FLOATS <= MAKER_THREADS, "named barriers; position makers");
static_assert(AHEAD + 2 <= NS, "the makers run up to NS - AHEAD stages ahead of the MMA warps");
static_assert(SMEM_BYTES <= 232448, "H100 shared memory per block");

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

__device__ __forceinline__ void bar_sync(int id)
{
    asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_sync_makers()
{
    asm volatile("bar.sync %0, %1;" :: "n"(MAKERS), "n"(MAKER_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id)
{
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(THREADS) : "memory");
}

// Data tile layout: time row tl of a stage holds the stage's 3*BA floats of
// that time step, from float (t * 3A) % 4 of the row on (the copies are
// aligned down to 16 bytes); rows are DATA_PITCH floats apart, which leaves
// at most two-way bank conflicts on the fragment loads.

// Angle tile layout: K-major core matrices for the wgmma B operand.  Column
// n < BK holds cos and n >= BK sin of k-point n % BK; per k-step ks and part
// (big, small) a 2 x 8 grid of core matrices, each 8 columns x 16 bytes
// (4 TF32 atoms): atom a = al % KATOMS of k-step al / KATOMS at
//   byte ((((ks * 2 + part) * 2 + a / 4) * 8 + n / 8) * 128 + (n % 8) * 16 + (a % 4) * 4.
// A stage fills B_STAGE floats (4 k-steps x 2 parts).
constexpr uint32_t CORE_K_STEP = 8 * 128;     // next 16 bytes of atoms (LBO)
constexpr uint32_t CORE_N_STEP = 128;         // next 8 columns (SBO)
constexpr uint32_t PART_BYTES = 2 * 8 * 128;  // one k-step's big or small tile

__device__ __forceinline__ uint32_t b_byte(int al, int n)
{
    const int ks = al / KATOMS, a = al % KATOMS;
    return (((ks * 2) * 2 + a / 4) * 8 + n / 8) * 128 + (n % 8) * 16 + (a % 4) * 4;
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
                      int grid_k, int accumulate)
{
    extern __shared__ __align__(16) unsigned char smem[];
    double* s_k = reinterpret_cast<double*>(smem);
    double* s_pos = s_k + BK * 3;   // two stages of (mp_hi + mp_lo) in float64
    float* s_tot = reinterpret_cast<float*>(s_pos + 2 * ROW_FLOATS);
    float* s_data = s_tot + ACC * MMA_THREADS;
    float* s_b = s_data + NS * DATA_STAGE;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, tq = lane % 4;
    const long long k0 = (long long)(blockIdx.x % grid_k) * BK;
    const long long t0 = (long long)(blockIdx.x / grid_k) * BT;
    const long long row_stride = n_atoms * 3;     // floats per time step
    const int n_stages = (int)((n_atoms + BA - 1) / BA);

    for (int i = tid; i < BK * 3; i += THREADS) {
        const long long k = k0 + i / 3;
        s_k[i] = k < n_k ? (double)kv[k * 3 + i % 3] : 0.0;
    }
    __syncthreads();

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
            piece_dst[r] = (uint32_t)__cvta_generic_to_shared(s_data + tl * DATA_PITCH + 4 * c);
            piece_src[r] = row - (row & 3) + 4 * c;
            piece_end[r] = t0 + tl < n_t ? row + row_stride : 0;
        }
        auto copy_data = [&](int s) {
            if (s >= n_stages)
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

        // Maker warp (ks, w), lane (g, tq): atoms 8 ks + tq and 8 ks + tq + 4,
        // k-points 16 w + 8 h + g for h = 0, 1.  Makers mtid < ROW_FLOATS
        // turn one float of the stage's positions into float64 for all; they
        // read it a stage ahead, so its latency hides behind a stage of work.
        const int gen_ks = mwarp / 2, gen_w = mwarp % 2;
        float hi_next = 0.0f, lo_next = 0.0f;
        auto read_position = [&](int s) {
            const long long o = (long long)s * ROW_FLOATS + mtid;
            const bool ok = mtid < ROW_FLOATS && o < row_stride;
            hi_next = ok ? mp_hi[o] : 0.0f;
            lo_next = ok ? mp_lo[o] : 0.0f;
        };
        read_position(0);
        for (int s = 0; s < AHEAD; ++s) {
            copy_data(s);
            cp_async_commit();
        }

        // Stage s: wait until the MMA warps are done with stage s + AHEAD - NS,
        // whose slot the copy of stage s + AHEAD takes; make stage s's angles
        // while that copy and the one of stage s + 1 are in flight.
        for (int s = 0; s < n_stages; ++s) {
            const int buf = s % NS;
            if (s >= NS - AHEAD)
                bar_sync(EMPTY + (s + AHEAD) % NS);
            copy_data(s + AHEAD);
            cp_async_commit();

            double* sp = s_pos + (s & 1) * ROW_FLOATS;
            if (mtid < ROW_FLOATS)
                sp[mtid] = (double)hi_next + (double)lo_next;
            if (s + 1 < n_stages)
                read_position(s + 1);
            bar_sync_makers();   // sp is complete; the stage before last no longer reads it
            double pos[2][3];
            bool atom_ok[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int al = 8 * gen_ks + tq + 4 * i;
                atom_ok[i] = (long long)s * BA + al < n_atoms;
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    pos[i][d] = sp[3 * al + d];
            }

            // The four angles first, without branches, so their latencies
            // overlap; a pair out of range takes angle 0 and is zeroed after.
            float ang32[2][2];
            bool ok[2][2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kl = 16 * gen_w + 8 * h + g;
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    double ang = pos[i][0] * s_k[3 * kl] + pos[i][1] * s_k[3 * kl + 1]
                               + pos[i][2] * s_k[3 * kl + 2];
                    ang -= TWO_PI * rint(ang * INV_TWO_PI);
                    ok[h][i] = atom_ok[i] && k0 + kl < n_k;
                    ang32[h][i] = ok[h][i] ? (float)ang : 0.0f;
                }
            }
            // Atom 8 gen_ks + tq + 4 i; column 16 w + 8 h + g (cos) and
            // BK + 16 w + 8 h + g (sin).
            unsigned char* sb = reinterpret_cast<unsigned char*>(s_b + buf * B_STAGE);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    float cs, sn;
                    sincosf(ang32[h][i], &sn, &cs);
                    const int al = 8 * gen_ks + tq + 4 * i, n = 16 * gen_w + 8 * h + g;
                    store_b(sb + b_byte(al, n), ok[h][i] ? cs : 0.0f);
                    store_b(sb + b_byte(al, n + BK), ok[h][i] ? sn : 0.0f);
                }
            }
            // The MMA warps read the angle tile through the async proxy.
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            cp_async_wait_ahead();
            bar_arrive(FULL + buf);
        }
        return;
    }

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
    const uint32_t b_base = (uint32_t)__cvta_generic_to_shared(s_b);

    constexpr int STAGES_PER_SUM = SUM_ATOMS / BA;
    for (int s = 0; s < n_stages; ++s) {
        const int buf = s % NS;
        bar_sync(FULL + buf);
        const float* sd = s_data + buf * DATA_STAGE;
        const uint32_t sb = b_base + buf * B_STAGE * sizeof(float);
#pragma unroll
        for (int k0s = 0; k0s < KSTEPS; k0s += CHAIN) {
            uint32_t a_big[CHAIN][4], a_small[CHAIN][4];
#pragma unroll
            for (int q = 0; q < CHAIN; ++q)
                load_a(sd + row_at[0] + 3 * KATOMS * (k0s + q),
                       sd + row_at[1] + 3 * KATOMS * (k0s + q), a_big[q], a_small[q]);
            // The tensor cores truncate when they add to the accumulator,
            // so each MMA sum covers only CHAIN_ATOMS atoms, from zero, and
            // is added in IEEE float32.
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < CHAIN; ++q) {
                const uint32_t b = sb + 2 * (k0s + q) * PART_BYTES;
                const uint64_t b_big = smem_desc(b, CORE_K_STEP, CORE_N_STEP);
                const uint64_t b_small = smem_desc(b + PART_BYTES, CORE_K_STEP, CORE_N_STEP);
                mma_step(step, a_big[q], a_small[q], b_big, b_small, q > 0);
            }
            wgmma_commit_wait();
#pragma unroll
            for (int i = 0; i < ACC; ++i)
                acc[i] += step[i];
        }
        if (s < n_stages - (NS - AHEAD))   // the makers wait for this stage
            bar_arrive(EMPTY + buf);

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

cudaError_t launch(const void* data, const void* mp_hi, const void* mp_lo, const void* kv,
                   void* out_re, void* out_im, long long n_t, long long n_atoms,
                   long long n_k, long long grid_t, long long grid_k, int accumulate,
                   cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        sed_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess)
        return err;
    sed_projection_kernel<<<(unsigned)(grid_t * grid_k), THREADS, SMEM_BYTES, stream>>>(
        (const float*)data, (const float*)mp_hi, (const float*)mp_lo,
        (const float*)kv, (float*)out_re, (float*)out_im, n_t, n_atoms, n_k,
        (int)grid_k, accumulate);
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
    const long long grid_t = (n_t + BT - 1) / BT;
    const long long grid_k = (n_k + BK - 1) / BK;
    if (grid_t * grid_k > 2147483647LL || (n_atoms + BA - 1) / BA > 2147483647LL)
        return (int)cudaErrorInvalidConfiguration;
    return (int)launch(data, mp_hi, mp_lo, kv, out_re, out_im, n_t, n_atoms, n_k, grid_t, grid_k,
                    accumulate, (cudaStream_t)stream);
}

// Dynamic shared memory of one block, in bytes (ptxas reports only static).
extern "C" int psa_sed_projection_smem_bytes()
{
    return SMEM_BYTES;
}
