// K2: per-frame spectral flatness and onset flux of a magnitude spectrogram.
//
// Replaces the TPU kernel audio_cut_tpu/ops/pallas/frame_stats.py
// (spectral_stats_pallas -> pallas_call, body _kernel). For mag [T, F]:
//
//     flatness[t] = exp(sum_f log(mag^2 + 1e-10) / F) / (sum_f mag^2 / F + 1e-10)
//     onset[t]    = sum_f max(log1p(1000 mag[t, f]) - log1p(1000 mag[t-1, f]), 0) / F
//
// with onset[0] = 0 (frame 0 fluxes against itself).
//
// Bound: memory. Each spectrogram value is read once and each frame writes
// two floats; the work per value is one log, two log1p and a few adds, far
// below what the card's arithmetic could take in the time the bytes need.
// On the main path (a 60 s song: T = 1201 frames of F = 1025 bins) one
// launch reads 4,924,100 B and writes 9,608 B: about 1.47 us at 3.35 TB/s.
//
// Design: one block of 256 threads per frame row; the threads stride over
// the bins, so neighbouring threads read neighbouring floats and loads
// coalesce. Each thread keeps three partial sums in registers (log power,
// power, rectified flux); a warp-shuffle reduction and one shared-memory
// step finish each sum, and thread 0 writes the two outputs. Row t-1 is
// read from the same buffer (the previous block's row, mostly from L2), so
// there is no pre-shifted second input. The Pallas kernel's 256-row tiles,
// its 128-lane padding with masked lanes and its 128-wide broadcast outputs
// follow Mosaic's (8, 128) tiling and have no counterpart here.
//
// Numerics: the accurate logf, expf and log1pf (no fast math); the squares
// and the adds around them are unfused (__fmul_rn/__fadd_rn) so nvcc does
// not contract them into an FMA the plain version does not compute. The
// means divide the sums by F, as the plain version's mean does. Only the
// order of the sums differs from the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float warp_sum(float v) {
    for (int offset = 16; offset > 0; offset >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, offset);
    }
    return v;
}

__global__ void __launch_bounds__(kThreads)
spectral_stats_kernel(const float* __restrict__ mag, float* __restrict__ flat,
                      float* __restrict__ onset, int n_bins) {
    const long long t = blockIdx.x;
    const float* row = mag + t * (long long)n_bins;
    const float* prev = t > 0 ? row - n_bins : row;

    float s_log = 0.0f, s_pow = 0.0f, s_flux = 0.0f;
    for (int f = threadIdx.x; f < n_bins; f += kThreads) {
        const float m = row[f];
        const float p = __fmul_rn(m, m);
        s_log += logf(__fadd_rn(p, kEps));
        s_pow += p;
        if (t > 0) {
            const float d = __fsub_rn(log1pf(__fmul_rn(1000.0f, m)),
                                      log1pf(__fmul_rn(1000.0f, prev[f])));
            s_flux += fmaxf(d, 0.0f);
        }
    }

    __shared__ float partial[3][kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    s_log = warp_sum(s_log);
    s_pow = warp_sum(s_pow);
    s_flux = warp_sum(s_flux);
    if (lane == 0) {
        partial[0][warp] = s_log;
        partial[1][warp] = s_pow;
        partial[2][warp] = s_flux;
    }
    __syncthreads();
    if (warp == 0) {
        s_log = lane < kWarps ? partial[0][lane] : 0.0f;
        s_pow = lane < kWarps ? partial[1][lane] : 0.0f;
        s_flux = lane < kWarps ? partial[2][lane] : 0.0f;
        s_log = warp_sum(s_log);
        s_pow = warp_sum(s_pow);
        s_flux = warp_sum(s_flux);
        if (lane == 0) {
            const float nf = (float)n_bins;
            flat[t] = expf(s_log / nf) / __fadd_rn(s_pow / nf, kEps);
            onset[t] = s_flux / nf;
        }
    }
}

}  // namespace

extern "C" int spectral_stats_launch(const void* mag, void* flat, void* onset,
                                     int n_frames, int n_bins, void* stream) {
    if (n_frames <= 0 || n_bins <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    spectral_stats_kernel<<<(unsigned)n_frames, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)mag, (float*)flat, (float*)onset, n_bins);
    return (int)cudaGetLastError();
}
