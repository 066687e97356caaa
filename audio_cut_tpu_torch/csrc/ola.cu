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
//
// K1 backward: the custom VJP of windowed_ola_pallas (_ola_bwd,
// audio_cut_tpu/ops/pallas/ola.py:77). For the cotangent g [B, (N-1)*hop + L]:
//
//     g_frames[b, i, c] = g[b, i*hop + c] * window[c]
//     g_window[c]       = sum_{b, i} g[b, i*hop + c] * frames[b, i, c]
//
// Bound: memory. g_frames reads g and the window once and writes B*N*L
// floats, one product each; g_window reads g and the frames once more. At the
// training shape [4, 128, 6144], hop 1024: 14.8 MB for g_frames alone, 27.4 MB
// with g_window.
//
// Design. Each thread owns 4 consecutive columns c and moves them as one
// float4 where hop and L are multiples of 4 and the pointers 16-byte aligned
// (the training path), else as 4 scalars. g_frames: one block per (row
// b * N + i, tile of 1024 columns); the read of g[b, i*hop + c ..] and the
// write of the frame row are contiguous runs. It is one rounded product per
// element, so it equals the plain version exactly. g_window is a reduction
// over all B*N rows: each block owns a tile of 1024 columns and a chunk of
// rows, sums its rows in registers (loads coalesced along c) and writes one
// row of partial sums; a second kernel adds the partial rows per column in
// chunk order. The result is deterministic (no float atomics); it differs from the
// plain version only in the order of the sums. The g_window kernels launch
// only where the window needs a gradient, which training never asks for.

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

// Each thread of the backward kernels owns 4 consecutive columns; with VEC
// (hop and L multiples of 4, every pointer 16-byte aligned) it moves them as
// one float4, else as 4 scalars.
constexpr int kCols = 4;

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int c, int limit) {
    if (VEC) {
        return *reinterpret_cast<const float4*>(p + c);
    }
    float4 v;
    v.x = c < limit ? p[c] : 0.0f;
    v.y = c + 1 < limit ? p[c + 1] : 0.0f;
    v.z = c + 2 < limit ? p[c + 2] : 0.0f;
    v.w = c + 3 < limit ? p[c + 3] : 0.0f;
    return v;
}

template <bool VEC>
__global__ void ola_backward_frames_kernel(const float* __restrict__ g,
                                           const float* __restrict__ window,
                                           float* __restrict__ g_frames,
                                           int n_frames, int frame_len, int hop) {
    const long long r = blockIdx.x;      // row b * N + i
    const long long b = r / n_frames;
    const long long i = r - b * n_frames;
    const int c = (blockIdx.y * blockDim.x + threadIdx.x) * kCols;
    if (c >= frame_len) {
        return;
    }
    const long long total = (long long)(n_frames - 1) * hop + frame_len;
    const float* gb = g + b * total + i * hop;
    float* out = g_frames + r * frame_len;
    const float4 gv = load4<VEC>(gb, c, frame_len);
    const float4 wv = load4<VEC>(window, c, frame_len);
    const float4 o = make_float4(__fmul_rn(gv.x, wv.x), __fmul_rn(gv.y, wv.y),
                                 __fmul_rn(gv.z, wv.z), __fmul_rn(gv.w, wv.w));
    if (VEC) {
        *reinterpret_cast<float4*>(out + c) = o;
    } else {
        const float vals[kCols] = {o.x, o.y, o.z, o.w};
        for (int k = 0; k < kCols && c + k < frame_len; ++k) {
            out[c + k] = vals[k];
        }
    }
}

template <bool VEC>
__global__ void ola_backward_window_partial_kernel(const float* __restrict__ g,
                                                   const float* __restrict__ frames,
                                                   float* __restrict__ partial,
                                                   int n_frames, int frame_len, int hop,
                                                   int rows, int rows_per_chunk) {
    const int c = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
    if (c >= frame_len) {
        return;
    }
    const long long total = (long long)(n_frames - 1) * hop + frame_len;
    const int r0 = blockIdx.y * rows_per_chunk;
    const int r1 = min(rows, r0 + rows_per_chunk);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
        const int b = r / n_frames;
        const int i = r - b * n_frames;
        const float4 gv = load4<VEC>(g + (long long)b * total + (long long)i * hop, c, frame_len);
        const float4 fv = load4<VEC>(frames + (long long)r * frame_len, c, frame_len);
        acc.x = fmaf(gv.x, fv.x, acc.x);
        acc.y = fmaf(gv.y, fv.y, acc.y);
        acc.z = fmaf(gv.z, fv.z, acc.z);
        acc.w = fmaf(gv.w, fv.w, acc.w);
    }
    float* out = partial + (long long)blockIdx.y * frame_len;
    const float vals[kCols] = {acc.x, acc.y, acc.z, acc.w};
    for (int k = 0; k < kCols && c + k < frame_len; ++k) {
        out[c + k] = vals[k];
    }
}

__global__ void ola_backward_window_sum_kernel(const float* __restrict__ partial,
                                               float* __restrict__ g_window,
                                               int frame_len, int n_chunks) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= frame_len) {
        return;
    }
    float acc = 0.0f;
    for (int k = 0; k < n_chunks; ++k) {  // fixed order: deterministic
        acc += partial[(long long)k * frame_len + c];
    }
    g_window[c] = acc;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
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

extern "C" int ola_backward_frames_launch(const void* g, const void* window, void* g_frames,
                                          int batch, int n_frames, int frame_len, int hop,
                                          void* stream) {
    if (batch <= 0 || n_frames <= 0 || hop <= 0 || frame_len % hop != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const long long rows = (long long)batch * n_frames;
    if (rows > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const int cols_per_block = kThreads * kCols;
    dim3 grid((unsigned)rows, (unsigned)((frame_len + cols_per_block - 1) / cols_per_block));
    const bool vec = hop % kCols == 0 && frame_len % kCols == 0 && aligned16(g) &&
                     aligned16(window) && aligned16(g_frames);
    if (vec) {
        ola_backward_frames_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)g, (const float*)window, (float*)g_frames, n_frames, frame_len, hop);
    } else {
        ola_backward_frames_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)g, (const float*)window, (float*)g_frames, n_frames, frame_len, hop);
    }
    return (int)cudaGetLastError();
}

extern "C" int ola_backward_window_launch(const void* g, const void* frames, void* partial,
                                          void* g_window, int batch, int n_frames,
                                          int frame_len, int hop, int rows_per_chunk,
                                          int n_chunks, void* stream) {
    if (batch <= 0 || n_frames <= 0 || hop <= 0 || frame_len % hop != 0 ||
        rows_per_chunk <= 0 || n_chunks <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const long long rows = (long long)batch * n_frames;
    // the chunks must cover the rows, and each must hold at least one
    if ((long long)n_chunks * rows_per_chunk < rows ||
        (long long)(n_chunks - 1) * rows_per_chunk >= rows || rows > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const int cols_per_block = kThreads * kCols;
    dim3 grid((unsigned)((frame_len + cols_per_block - 1) / cols_per_block), (unsigned)n_chunks);
    const bool vec = hop % kCols == 0 && frame_len % kCols == 0 && aligned16(g) &&
                     aligned16(frames);
    if (vec) {
        ola_backward_window_partial_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)g, (const float*)frames, (float*)partial, n_frames, frame_len, hop,
            (int)rows, rows_per_chunk);
    } else {
        ola_backward_window_partial_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)g, (const float*)frames, (float*)partial, n_frames, frame_len, hop,
            (int)rows, rows_per_chunk);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return (int)err;
    }
    ola_backward_window_sum_kernel<<<(frame_len + kThreads - 1) / kThreads, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const float*)partial, (float*)g_window, frame_len, n_chunks);
    return (int)cudaGetLastError();
}
