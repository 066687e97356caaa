// K1: windowed overlap-add, the tail of every iSTFT.
//
// Replaces the TPU kernel audio_cut_tpu/ops/pallas/ola.py
// (windowed_ola_pallas -> _windowed_ola_pallas_impl -> pallas_call, body
// _make_kernel). It computes, for frames [B, N, L] and window [L] with
// hop | L and r = L / hop,
//
//     out[b, j*hop + u] = sum_{m=0}^{r-1} frames[b, j-m, m*hop + u] * window[m*hop + u]
//
// over 0 <= j - m < N, for output hop-tiles j in [0, N + r - 1) and
// u in [0, hop). The output has (N + r - 1) * hop = (N - 1) * hop + L samples.
//
// Bound: memory. Each frame sample is read once, each output sample written
// once, with r multiply-adds per output sample (r = 6 on the serving path):
// about 0.2 operations per byte, far below the card's balance point. At the
// serving shape [4, 256, 6144], hop 1024, one launch moves 25.2 MB in and
// 4.3 MB out.
//
// Design: one block per (output hop-tile j, batch b); its threads walk u.
// For a fixed (j, m) the threads read frames[b, j-m, m*hop .. m*hop+hop)
// as one contiguous run, so loads coalesce; each output sample is summed in
// a register and written once, so no atomics and no second pass. The frame
// rows outside [0, N) at the two ragged ends are masked, not padded. The
// Pallas kernel's 8-row sublane blocking and top padding are TPU layout
// constraints and have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void windowed_ola_kernel(const float* __restrict__ frames,
                                    const float* __restrict__ window,
                                    float* __restrict__ out,
                                    int n_frames, int frame_len, int hop) {
    const int r = frame_len / hop;
    const int j = blockIdx.x;            // output hop-tile
    const long long b = blockIdx.y;      // batch row
    const long long frame_stride = (long long)frame_len;
    const float* fb = frames + b * (long long)n_frames * frame_stride;
    float* ob = out + b * (long long)(n_frames + r - 1) * hop + (long long)j * hop;

    // frames j-m must lie in [0, n_frames): m in [m_lo, m_hi]
    const int m_lo = max(0, j - (n_frames - 1));
    const int m_hi = min(r - 1, j);
    for (int u = threadIdx.x; u < hop; u += blockDim.x) {
        float acc = 0.0f;
        for (int m = m_lo; m <= m_hi; ++m) {
            const int col = m * hop + u;
            // unfused multiply then add, in the plain version's order
            // (m ascending), so the two agree bit for bit
            acc = __fadd_rn(acc, __fmul_rn(fb[(long long)(j - m) * frame_stride + col],
                                           window[col]));
        }
        ob[u] = acc;
    }
}

}  // namespace

extern "C" int windowed_ola_launch(const void* frames, const void* window, void* out,
                                   int batch, int n_frames, int frame_len, int hop,
                                   void* stream) {
    if (batch <= 0 || n_frames <= 0 || hop <= 0 || frame_len % hop != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int r = frame_len / hop;
    dim3 grid((unsigned)(n_frames + r - 1), (unsigned)batch);
    const int threads = hop < kThreads ? ((hop + 31) / 32) * 32 : kThreads;
    windowed_ola_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)frames, (const float*)window, (float*)out, n_frames, frame_len, hop);
    return (int)cudaGetLastError();
}
