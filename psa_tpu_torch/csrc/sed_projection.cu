// Fused phase generation + atom contraction of the SED, for Hopper (sm_90a).
//
//   out_re[t, c, k] = sum_a data[t, a, c] * cos(A[a, k])
//   out_im[t, c, k] = sum_a data[t, a, c] * sin(A[a, k])
//   A[a, k]         = (mp_hi + mp_lo)[a] . kv[k], folded into [-pi, pi]
//
// Replaces the Pallas TPU kernel psa_tpu/ops/pallas_sed.py::sed_projection_pallas
// (body _projection_kernel, angle tile _angles_tile).  As there, the (A, 2K)
// phase table never reaches device memory.
//
// Design:
//   * One thread block owns one output tile of BT time steps (BM = 3*BT rows
//     (t, c)) by BK k-points and walks the whole atom axis itself, BA atoms at
//     a time.  No cross-block reduction, no atomics: the sum order is fixed,
//     so results are identical from run to run.
//   * Per atom chunk the block builds the BA x BK angle tile in double
//     precision (the card has native FP64, so the double-single arithmetic the
//     TPU needed is not used), folds it by 2*pi in double, casts to float and
//     takes sincosf (accurate libm version: this file must not be built with
//     --use_fast_math).  cos, sin and the data tile sit in shared memory.
//   * Each thread accumulates a TM x TK register tile of both outputs with
//     IEEE float32 FMA on the CUDA cores: no TF32, no bf16.  Each atom chunk
//     is summed into fresh registers and then added to the running total, so
//     rounding error grows with the number of chunks, not of atoms.  On an
//     H100 at (n_t, A, K) = (10^4, 10^5, 500), one flat running sum was
//     1.3e-5 (of max|out|) off a float64 sum of the same products, this
//     two-level sum 2.2e-6, cuBLAS float32 4.2e-6.
//     __launch_bounds__(THREADS, 2) holds it at 128 registers, two blocks
//     per SM, without spills.
//   * The trajectory is read in its natural (n_t, A, 3) layout; outputs are
//     written as (n_t, 3, K) so the time FFT runs over dim 0.  Ragged n_t, A
//     and K are masked here; callers pad nothing.
//
// What bounds it on this card: float32 FMA issue on the CUDA cores
// (2 * 3 n_t * A * K FMAs) and the shared-memory loads that feed them, plus
// sincosf and the FP64 fold for the angle tile.  The angle tile is recomputed
// once per time tile, so the angle work is about (3 n_t / BM) * A * K
// evaluations, 1/(2 BM) of the FMA count.  Tensor cores (3xTF32 split
// products, or wgmma) and a TMA/cp.async pipeline are later work.
//
// Entry point psa_sed_projection launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BT = 32;            // time steps per block
constexpr int BM = 3 * BT;        // output rows (t, c) per block
constexpr int BK = 64;            // k-points per block
constexpr int BA = 32;            // atoms per chunk of the reduction
constexpr int TM = 6;             // rows per thread
constexpr int TK = 4;             // k-points per thread
constexpr int THREADS_M = BM / TM;             // 16
constexpr int THREADS_K = BK / TK;             // 16
constexpr int THREADS = THREADS_M * THREADS_K; // 256
constexpr int DATA_LD = BM + 2;   // padded row: fewer bank conflicts on store

constexpr double TWO_PI = 6.283185307179586476925286766559;
constexpr double INV_TWO_PI = 0.15915494309189533576888376337251;

__global__ void __launch_bounds__(THREADS, 2)
sed_projection_kernel(const float* __restrict__ data,
                      const float* __restrict__ mp_hi,
                      const float* __restrict__ mp_lo,
                      const float* __restrict__ kv,
                      float* __restrict__ out_re,
                      float* __restrict__ out_im,
                      long long n_t, long long n_atoms, long long n_k)
{
    __shared__ __align__(16) float s_cos[BA][BK];
    __shared__ __align__(16) float s_sin[BA][BK];
    __shared__ __align__(16) float s_data[BA][DATA_LD];
    __shared__ double s_pos[BA][3];
    __shared__ double s_k[BK][3];

    const int tid = threadIdx.x;
    const int tx = tid % THREADS_K;     // k sub-tile
    const int ty = tid / THREADS_K;     // row sub-tile
    const long long t0 = (long long)blockIdx.x * BT;
    const long long k0 = (long long)blockIdx.y * BK;
    const long long row_stride = n_atoms * 3;   // floats per time step

    for (int i = tid; i < BK * 3; i += THREADS) {
        const long long k = k0 + i / 3;
        s_k[i / 3][i % 3] = k < n_k ? (double)kv[k * 3 + i % 3] : 0.0;
    }

    float acc_re[TM][TK];
    float acc_im[TM][TK];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TK; ++j) {
            acc_re[i][j] = 0.0f;
            acc_im[i][j] = 0.0f;
        }
    }

    for (long long a0 = 0; a0 < n_atoms; a0 += BA) {
        __syncthreads();   // the previous chunk's tiles are no longer read

        if (tid < BA * 3) {
            const long long a = a0 + tid / 3;
            const long long off = a * 3 + tid % 3;
            s_pos[tid / 3][tid % 3] =
                a < n_atoms ? (double)mp_hi[off] + (double)mp_lo[off] : 0.0;
        }
        // Data tile: BT time steps x (BA atoms x 3) contiguous floats each.
        for (int i = tid; i < BT * BA * 3; i += THREADS) {
            const int tl = i / (BA * 3);
            const int rem = i % (BA * 3);
            const long long t = t0 + tl;
            const long long a = a0 + rem / 3;
            float v = 0.0f;
            if (t < n_t && a < n_atoms)
                v = data[t * row_stride + a0 * 3 + rem];
            s_data[rem / 3][tl * 3 + rem % 3] = v;
        }
        __syncthreads();

        for (int i = tid; i < BA * BK; i += THREADS) {
            const int al = i / BK;
            const int kl = i % BK;
            float c = 0.0f, s = 0.0f;
            if (a0 + al < n_atoms && k0 + kl < n_k) {
                double ang = s_pos[al][0] * s_k[kl][0]
                           + s_pos[al][1] * s_k[kl][1]
                           + s_pos[al][2] * s_k[kl][2];
                ang -= TWO_PI * rint(ang * INV_TWO_PI);
                sincosf((float)ang, &s, &c);
            }
            s_cos[al][kl] = c;
            s_sin[al][kl] = s;
        }
        __syncthreads();

        float p_re[TM][TK];
        float p_im[TM][TK];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TK; ++j) {
                p_re[i][j] = 0.0f;
                p_im[i][j] = 0.0f;
            }
        }
#pragma unroll 4
        for (int a = 0; a < BA; ++a) {
            float d[TM];
            const float2* drow = reinterpret_cast<const float2*>(&s_data[a][ty * TM]);
#pragma unroll
            for (int i = 0; i < TM / 2; ++i) {
                const float2 v = drow[i];
                d[2 * i] = v.x;
                d[2 * i + 1] = v.y;
            }
            const float4 cv = *reinterpret_cast<const float4*>(&s_cos[a][tx * TK]);
            const float4 sv = *reinterpret_cast<const float4*>(&s_sin[a][tx * TK]);
            const float cs[TK] = {cv.x, cv.y, cv.z, cv.w};
            const float sn[TK] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
                for (int j = 0; j < TK; ++j) {
                    p_re[i][j] = fmaf(d[i], cs[j], p_re[i][j]);
                    p_im[i][j] = fmaf(d[i], sn[j], p_im[i][j]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TK; ++j) {
                acc_re[i][j] += p_re[i][j];
                acc_im[i][j] += p_im[i][j];
            }
        }
    }

    const long long n_rows = n_t * 3;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = t0 * 3 + ty * TM + i;
        if (m >= n_rows)
            continue;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
            const long long k = k0 + tx * TK + j;
            if (k < n_k) {
                out_re[m * n_k + k] = acc_re[i][j];
                out_im[m * n_k + k] = acc_im[i][j];
            }
        }
    }
}

}  // namespace

extern "C" int psa_sed_projection(const void* data, const void* mp_hi,
                               const void* mp_lo, const void* kv,
                               void* out_re, void* out_im,
                               long long n_t, long long n_atoms,
                               long long n_k, void* stream)
{
    if (n_t < 1 || n_atoms < 1 || n_k < 1)
        return (int)cudaErrorInvalidValue;
    const long long grid_t = (n_t + BT - 1) / BT;
    const long long grid_k = (n_k + BK - 1) / BK;
    if (grid_t > 2147483647LL || grid_k > 65535LL)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)grid_t, (unsigned)grid_k);
    sed_projection_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const float*)mp_hi, (const float*)mp_lo,
        (const float*)kv, (float*)out_re, (float*)out_im, n_t, n_atoms, n_k);
    return (int)cudaGetLastError();
}
