// Fused instantaneous phasors + atom contraction of the DSF family's mode
// stacks, for Hopper (sm_90a), under phase_mode 'exact'.
//
//   acc_re[t, k, c] += sum_a w_c(a, t) * cos(theta(t, a, k))
//   acc_im[t, k, c] += sum_a w_c(a, t) * sin(theta(t, a, k))
//   theta = fold_2pi(double(r_a(t)) . double(k)), rounded to float32 once
//   w     = [1, v_x, v_y, v_z] * weight_a   (C = 4), or [weight_a] (C = 1)
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (psa_tpu/ops/instantaneous.py).  The port ran it as a loop of time tiles
// of PyTorch ops (ops/instantaneous.py::accumulate_modes_plain: float64
// k.r, divide, round, subtract, cast, cos, sin, a float32 bmm), each a pass
// over a (t, A, K) tensor in device memory that no caller reads.  Here the
// phasor lives in registers and goes straight into the sums.
//
// Arithmetic, element by element that of the plain chain: the angle is the
// float64 dot product of the widened float32 position and float32 k, folded
// by theta - 2 pi rint(theta / 2 pi) in float64 (as the multiply by 1 / 2 pi
// of sed_projection.cu: it differs from the division only where theta / 2 pi
// lies within an ulp of a half turn, where both folds give +-pi), cast to
// float32 once; cos and sin from the accurate sincosf (this file must not be
// built with --use_fast_math); the products w * cos, w * sin in IEEE float32
// (fmaf), with w = fl(weight_a * v) rounded first, as the plain chain's
// `w *= weights`.  No TF32, no bf16, no table.
//
// What bounds it, at the DSF cell's call (n_t, A, K, C) = (1e4, 32,000, 128,
// 4), 4.1e10 elements.  The function needs per element 6 float64
// operations (3 for the dot, the multiply by 1 / 2 pi, rint, the fold), one
// F2F.F32.F64, a sincosf of CUDA's accuracy on a folded angle (~21
// instructions: the quadrant by a magic-number add, a 3-part reduction, two
// polynomials, the quadrant's swap and signs) and 8 FMAs into [rho, j_x,
// j_y, j_z] (re, im): ~36 issue slots, 44.1 ms at 4 warp instructions a
// clock on 132 SMs at 1,980 MHz, the clock the card held while it ran.  This
// implementation issues 46.4 an element in the SASS (sincosf's F2I and I2F,
// the branch around its large-argument path, the shared-memory reads): its
// own ceiling, 56.8 ms.  The trajectory is read once per k-tile (7.7 GB, 2.3
// ms each): the bound is instruction issue, not bytes.
//
// Design:
//   * A block owns BT = 8 frames (one warp each) by BK = 32 KP = 64
//     k-points (KP = 2 per lane, k = k0 + lane + 32 j, so a warp's lanes
//     share the frame's atom data, read from shared memory as broadcasts).
//     Each lane keeps KP x C x 2 float32 sums in registers; at 64 registers
//     a thread MIN_BLOCKS = 4 blocks share an SM (32 warps).
//   * Each sincosf is a branch (around its large-argument path, never taken
//     for a folded angle) that no instruction is scheduled across.  So the
//     float64 angles of AP = 4 atoms are formed first, 8 independent chains,
//     then their sincosf and products.
//   * Atoms go in stages of BA = 128: all 256 threads read the stage's
//     positions (and velocities) of the block's frames from device memory,
//     widen the positions to float64 once (the lanes then read them from
//     shared memory, so no lane converts a position), multiply the
//     velocities by the atom's weight, and store the weight itself as the
//     density channel's w.
//   * Two-level sum: each stage's BA products start from zero in a run
//     register and are then added to the lane's total; a flat float32 sum
//     over 32,000 atoms is never formed.
//   * The atom axis may be split over `splits` blocks per output tile for
//     parallelism (ops/instantaneous.py::modes_splits picks it from the
//     shape, these tiles (psa_instant_modes_tile) and the blocks the card
//     holds at once): each split's totals go
//     to its own slice of a scratch, and a second kernel adds the slices in
//     split order, then adds that sum to acc.  Unsplit, the block adds its
//     totals to acc itself.  No atomics: the order of every sum is fixed,
//     and two launches on the same inputs give the same bits.  The split
//     depends on neither C nor the weights, so the density channel of C = 4
//     and C = 1 are the same bits.
//   * Any row and atom strides of positions and velocities (an atom slice
//     of a wider (n_t, N, 3) array), component stride 1.  Ragged n_t, A and
//     K are guarded: a frame past n_t loads zeros and stores nothing, a lane
//     past n_k multiplies k = 0 and stores nothing.  Nothing is padded.
//   * acc is a contiguous (n_t, K, C) float32 array (a row slice of a
//     longer one is); the kernels add to it and never overwrite it.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit, 1,980 MHz held) at the
// DSF cell's call, timed in turns with CUDA events: 77.2-77.5 ms against
// 1,664-1,676 ms for the plain chain, 57% of the function's 44.1 ms and 73%
// of this code's 56.8 ms; 4 atom splits, the second kernel 0.08 ms.  Kept out, measured in the same way: KP = 4 at 2
// blocks an SM, 80.3 ms (KP = 1: 98.7); AP = 1, 79-81 ms (AP = 8: 82.3); the
// rint as a magic-number add, +1%; a clamp before sincosf, +4%;
// __builtin_assume on its argument, no change; totals in shared memory,
// +1.5%.
//
// Entry point psa_instant_modes launches on the given stream, does not
// synchronise, allocates nothing, and returns the first CUDA error (0 if
// none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 8;                     // frames per block: one warp each
constexpr int THREADS = 32 * BT;          // 256
constexpr int KP = 2;                     // k-points per lane
constexpr int BK = 64;                    // k-points per block
constexpr int BA = 128;                   // atoms per stage = per run of the two-level sum
constexpr int AP = 4;                     // atoms whose angles are formed before their sincosf
constexpr int MIN_BLOCKS = 4;             // blocks per SM the register budget is set for
constexpr int REDUCE_THREADS = 256;

static_assert(BK == 32 * KP, "KP k-points on each lane of a warp");
static_assert(BT * 3 * BA % THREADS == 0, "every thread stages the same number of floats");

constexpr double TWO_PI = 6.283185307179586476925286766559;
constexpr double INV_TWO_PI = 0.15915494309189533576888376337251;

template <int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
instant_modes_kernel(const float* __restrict__ pos, long long pos_st, long long pos_sa,
                     const float* __restrict__ vel, long long vel_st, long long vel_sa,
                     const float* __restrict__ weights, const float* __restrict__ kv,
                     float* __restrict__ acc_re, float* __restrict__ acc_im,
                     float* __restrict__ part_re, float* __restrict__ part_im,
                     long long n_t, long long n_atoms, long long n_k, int grid_k, int splits,
                     long long split_atoms)
{
    __shared__ double2 s_xy[BT][BA];                  // x, y in float64
    __shared__ double s_z[BT][BA];                    // z in float64
    __shared__ float4 s_v[BT][C == 4 ? BA : 1];       // weight * (v_x, v_y, v_z), weight
    __shared__ float s_w[C == 4 ? 1 : BA];            // weight (C = 1)

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const long long b = blockIdx.x;
    const int kt = (int)(b % grid_k);
    const long long rest = b / grid_k;
    const int split = (int)(rest % splits);
    const long long t0 = (rest / splits) * BT;
    const long long t = t0 + warp;
    const long long a_begin = (long long)split * split_atoms;
    const long long a_end = a_begin + split_atoms < n_atoms ? a_begin + split_atoms : n_atoms;

    double kx[KP], ky[KP], kz[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
        const long long k = (long long)kt * BK + lane + 32 * j;
        const bool ok = k < n_k;
        kx[j] = ok ? (double)kv[3 * k] : 0.0;
        ky[j] = ok ? (double)kv[3 * k + 1] : 0.0;
        kz[j] = ok ? (double)kv[3 * k + 2] : 0.0;
    }
    float tot_re[KP][C], tot_im[KP][C];
#pragma unroll
    for (int j = 0; j < KP; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
            tot_re[j][c] = tot_im[j][c] = 0.0f;

    for (long long a0 = a_begin; a0 < a_end; a0 += BA) {
        const int n = a_end - a0 < BA ? (int)(a_end - a0) : BA;
        __syncthreads();   // the last stage is read
        // Stage the block's frames: 3 BA floats of positions (and of
        // velocities) per frame, one element per thread and step.
#pragma unroll 4
        for (int i = tid; i < BT * 3 * BA; i += THREADS) {
            const int tl = i / (3 * BA), e = i % (3 * BA), a = e / 3, d = e % 3;
            const long long tt = t0 + tl;
            const bool ok = tt < n_t && a < n;
            const float x = ok ? pos[tt * pos_st + (a0 + a) * pos_sa + d] : 0.0f;
            if (d == 2)
                s_z[tl][a] = (double)x;
            else
                reinterpret_cast<double*>(&s_xy[tl][a])[d] = (double)x;
            if constexpr (C == 4) {
                const float w = ok && weights != nullptr ? weights[a0 + a] : 1.0f;
                const float v = ok && vel != nullptr ? vel[tt * vel_st + (a0 + a) * vel_sa + d]
                                                     : 0.0f;
                reinterpret_cast<float*>(&s_v[tl][a])[d] = v * w;
                if (d == 0)
                    s_v[tl][a].w = w;
            }
        }
        if constexpr (C == 1) {
            for (int a = tid; a < BA; a += THREADS)
                s_w[a] = a < n && weights != nullptr ? weights[a0 + a] : 1.0f;
        }
        __syncthreads();
        if (t >= n_t)       // warp-uniform: a frame past the end only stages
            continue;

        float run_re[KP][C], run_im[KP][C];
#pragma unroll
        for (int j = 0; j < KP; ++j)
#pragma unroll
            for (int c = 0; c < C; ++c)
                run_re[j][c] = run_im[j][c] = 0.0f;
        // Atom a's folded float32 angles at the lane's KP k-points.
        const auto angles = [&](int a, float (&ang32)[KP]) {
            const double2 xy = s_xy[warp][a];
            const double z = s_z[warp][a];
#pragma unroll
            for (int j = 0; j < KP; ++j) {
                double ang = xy.x * kx[j] + xy.y * ky[j] + z * kz[j];
                ang -= TWO_PI * rint(ang * INV_TWO_PI);
                ang32[j] = (float)ang;
            }
        };
        // Atom a's phasors times its weights, into the runs.
        const auto contract = [&](int a, const float (&ang32)[KP]) {
            float w[4];
            if constexpr (C == 4) {
                const float4 v = s_v[warp][a];
                w[0] = v.w;
                w[1] = v.x;
                w[2] = v.y;
                w[3] = v.z;
            } else {
                w[0] = s_w[a];
            }
#pragma unroll
            for (int j = 0; j < KP; ++j) {
                float sn, cs;
                sincosf(ang32[j], &sn, &cs);
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    run_re[j][c] = fmaf(w[c], cs, run_re[j][c]);
                    run_im[j][c] = fmaf(w[c], sn, run_im[j][c]);
                }
            }
        };
        // The angles of AP atoms, then their phasors (Design, above).
        int a = 0;
        for (; a + AP <= n; a += AP) {
            float ang32[AP][KP];
#pragma unroll
            for (int u = 0; u < AP; ++u)
                angles(a + u, ang32[u]);
#pragma unroll
            for (int u = 0; u < AP; ++u)
                contract(a + u, ang32[u]);
        }
        for (; a < n; ++a) {
            float ang32[KP];
            angles(a, ang32);
            contract(a, ang32);
        }
#pragma unroll
        for (int j = 0; j < KP; ++j)
#pragma unroll
            for (int c = 0; c < C; ++c) {
                tot_re[j][c] += run_re[j][c];
                tot_im[j][c] += run_im[j][c];
            }
    }
    if (t >= n_t)
        return;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
        const long long k = (long long)kt * BK + lane + 32 * j;
        if (k >= n_k)
            continue;
        const long long i = (t * n_k + k) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (splits == 1) {
                acc_re[i + c] += tot_re[j][c];
                acc_im[i + c] += tot_im[j][c];
            } else {
                const long long p = (long long)split * n_t * n_k * C + i + c;
                part_re[p] = tot_re[j][c];
                part_im[p] = tot_im[j][c];
            }
        }
    }
}

// acc[i] += (((part[0][i] + part[1][i]) + part[2][i]) + ...), re and im.
__global__ void __launch_bounds__(REDUCE_THREADS)
instant_modes_reduce_kernel(float* __restrict__ acc_re, float* __restrict__ acc_im,
                     const float* __restrict__ part_re, const float* __restrict__ part_im,
                     long long n, int splits)
{
    for (long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * REDUCE_THREADS) {
        float re = part_re[i], im = part_im[i];
        for (int s = 1; s < splits; ++s) {
            re += part_re[s * n + i];
            im += part_im[s * n + i];
        }
        acc_re[i] += re;
        acc_im[i] += im;
    }
}

template <int C>
cudaError_t launch(const float* pos, long long pos_st, long long pos_sa, const float* vel,
                   long long vel_st, long long vel_sa, const float* weights, const float* kv,
                   float* acc_re, float* acc_im, float* part, long long n_t, long long n_atoms,
                   long long n_k, long long splits, long long split_atoms, cudaStream_t stream)
{
    const long long grid_t = (n_t + BT - 1) / BT, grid_k = (n_k + BK - 1) / BK;
    const long long blocks = grid_t * grid_k * splits;
    if (blocks > 2147483647LL || grid_k > 2147483647LL || splits > 2147483647LL)
        return cudaErrorInvalidConfiguration;
    const long long n = n_t * n_k * C;
    float* part_re = part;
    float* part_im = part == nullptr ? nullptr : part + splits * n;
    instant_modes_kernel<C><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pos, pos_st, pos_sa, vel, vel_st, vel_sa, weights, kv, acc_re, acc_im, part_re, part_im,
        n_t, n_atoms, n_k, (int)grid_k, (int)splits, split_atoms);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1)
        return err;
    long long grid = (n + REDUCE_THREADS - 1) / REDUCE_THREADS;
    grid = grid < 132 * 16 ? grid : 132 * 16;
    instant_modes_reduce_kernel<<<(unsigned)grid, REDUCE_THREADS, 0, stream>>>(
        acc_re, acc_im, part_re, part_im, n, (int)splits);
    return cudaGetLastError();
}

}  // namespace

// pos, vel: (n_t, n_atoms, 3) float32 with element strides (row, atom, 1);
// vel may be null (zero currents).  weights: (n_atoms,) or null (ones).
// kv: (n_k, 3) float32.  acc_re, acc_im: contiguous (n_t, n_k, n_ch)
// float32, added to.  With splits > 1, part is a scratch of 2 splits n_t n_k
// n_ch floats and each split takes split_atoms atoms (the last ragged);
// with splits == 1 it may be null.
extern "C" int psa_instant_modes(const void* pos, long long pos_st, long long pos_sa,
                                 const void* vel, long long vel_st, long long vel_sa,
                                 const void* weights, const void* kv, void* acc_re, void* acc_im,
                                 void* part, long long n_t, long long n_atoms, long long n_k,
                                 int n_ch, long long splits, long long split_atoms, void* stream)
{
    if (n_t < 1 || n_atoms < 1 || n_k < 1 || splits < 1 || split_atoms < 1
        || split_atoms % BA != 0 || (splits - 1) * split_atoms >= n_atoms
        || splits * split_atoms < n_atoms || (splits > 1 && part == nullptr)
        || (n_ch != 1 && n_ch != 4))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* p = (const float*)pos;
    const float* v = (const float*)vel;
    const float* w = (const float*)weights;
    const float* k = (const float*)kv;
    if (n_ch == 4)
        return (int)launch<4>(p, pos_st, pos_sa, v, vel_st, vel_sa, w, k, (float*)acc_re,
                              (float*)acc_im, (float*)part, n_t, n_atoms, n_k, splits,
                              split_atoms, s);
    return (int)launch<1>(p, pos_st, pos_sa, v, vel_st, vel_sa, w, k, (float*)acc_re,
                          (float*)acc_im, (float*)part, n_t, n_atoms, n_k, splits, split_atoms, s);
}

// The kernel's tiles, which ops/instantaneous.py plans the atom splits
// with: axis 0 the frames of a block (BT), 1 its k-points (BK), 2 the atoms
// of a stage (BA); -1 for another axis.
extern "C" int psa_instant_modes_tile(int axis)
{
    return axis == 0 ? BT : axis == 1 ? BK : axis == 2 ? BA : -1;
}

// Blocks of the C = 4 kernel one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int psa_instant_modes_active_blocks()
{
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, instant_modes_kernel<4>, THREADS, 0);
    return err == cudaSuccess ? blocks : -(int)err;
}
