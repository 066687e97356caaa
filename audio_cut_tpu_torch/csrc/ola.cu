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
// about 0.2 operations per byte, far below the card's balance point. At a
// piece of the serving path, [2, 256, 6144] hop 1024, one launch moves 12.6
// MB in and 2.1 MB out: 4.4 us at 3.35 TB/s.
//
// What held the first design back: one block per (output hop-tile j, batch
// b), its threads walking u one sample at a time (4 passes at hop 1024),
// each summing its r terms in a loop with runtime bounds. nvcc unrolls that
// loop by 4 with the loads interleaved with their uses, so a thread moved
// 4-byte loads a few at a time, in a chain of dependent round trips to
// device memory: 2 per pass at r = 6. In a grid of one or two waves nothing
// hid that chain, and the kernel took about twice its bound at the piece.
//
// Design: the same grid, one block per (hop-tile j, batch b), and no atomics
// or second pass: each output sample is summed in a register and written
// once. A thread owns 4 consecutive samples u..u+3 of the tile and moves
// them as one float4 where hop and L are multiples of 4 and the pointers
// 16-byte aligned (every path's shape), else as 4 masked scalars in the same
// structure. A block of min(256, hop / 4) threads covers a tile of up to
// 1024 samples in one pass, and takes further passes over a wider one. The
// loop over m is unrolled to kMaxRatio terms, those outside [m_lo, m_hi]
// (frame rows outside [0, N) at the two ragged ends) skipped by a branch
// that is uniform across the block: a thread issues the loads of every
// frame slice frames[b, j-m, m*hop + u ..] and of the window's beside them
// before its first multiply, so one round trip serves all r terms, with
// 16-byte loads. Above kMaxRatio the thread takes the terms in chunks of
// kMaxRatio, each chunk's loads issued together. The sum is an unfused
// multiply then an add, m ascending (__fmul_rn, __fadd_rn: no FMA
// contraction), the order of the plain version (ops/stft.py:overlap_add
// after frames * window), so the two agree bit for bit. The Pallas kernel's
// 8-row sublane blocking and top padding are TPU layout constraints and have
// no counterpart here.
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
// element, so it equals the plain version exactly.
//
// g_window is a reduction over all B*N rows, in one launch with no global
// scratch and no float atomics. The grid is column tiles x row ranks; the
// ranks of one tile form a thread-block cluster (at most 8 blocks, the
// portable size). A block is column lanes (4 columns each) x row lanes; the
// tile's ranks x row lanes are its lanes q, and lane q sums rows
// [q * rows_per_lane, (q + 1) * rows_per_lane) in registers, in row order,
// with the loads of kRowsInFlight rows issued before the first FMA that uses
// them. The row lanes of a block add up in shared memory in lane order. Each
// rank owns a slice of the tile's column lanes: every rank stores its partial
// row's lanes straight into their owner's shared memory (st.async through
// distributed shared memory), and each owner waits on an mbarrier in its own
// shared memory for the bytes of every rank, adds them rank 0 first and
// writes g_window. A rank so waits only for the data it needs, and no block
// reads another's shared memory after a barrier, so none is needed at the
// end: the one cluster barrier, split in two, only makes every block's
// mbarrier ready before a peer stores to it, and its wait comes after the
// rows, when every peer has long arrived. Each step issues its loads together
// and only then adds in order. Every wait is bounded: past kMaxSpins tries
// the kernel traps rather than hang the card. A trap ends the process's CUDA
// context: it shows as a CUDA error, and every later CUDA call of the process
// fails, so it is a fault to find, not one to recover from.
// The order of the sums depends only on the plan (tile width, row lanes,
// cluster size, rows per lane: ops/ola.py:window_plan), so two launches give
// the same bits; the result differs from the plain version only in that
// order. A lane or a rank may have no rows. The g_window kernel launches
// only where the window needs a gradient, which training never asks for.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Each thread of the kernels owns 4 consecutive samples (columns); with VEC
// (hop and L multiples of 4, every pointer 16-byte aligned) it moves them as
// one float4, else as 4 scalars masked at the run's end.
constexpr int kCols = 4;
// K1's terms whose loads a thread issues together: r = 6 (the ConvTDF's
// n_fft / hop) and r = 4 (the spectral backend's) in one round trip. More
// slots only cost registers and time
constexpr int kMaxRatio = 6;

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
__device__ __forceinline__ void store4(float* p, int c, int limit, float4 v) {
    if (VEC) {
        *reinterpret_cast<float4*>(p + c) = v;
        return;
    }
    const float vals[kCols] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < kCols && c + k < limit; ++k) {
        p[c + k] = vals[k];
    }
}

// acc + a * b, the product rounded before the add (never an FMA)
__device__ __forceinline__ float4 mul_add4(float4 acc, float4 a, float4 b) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(a.x, b.x)), __fadd_rn(acc.y, __fmul_rn(a.y, b.y)),
                       __fadd_rn(acc.z, __fmul_rn(a.z, b.z)), __fadd_rn(acc.w, __fmul_rn(a.w, b.w)));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
windowed_ola_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                    float* __restrict__ out, int n_frames, int frame_len, int hop) {
    const int r = frame_len / hop;
    const int j = blockIdx.x;            // output hop-tile
    const long long b = blockIdx.y;      // batch row
    const float* fb = frames + b * (long long)n_frames * frame_len;
    float* ob = out + b * (long long)(n_frames + r - 1) * hop + (long long)j * hop;

    // frames j-m must lie in [0, n_frames): m in [m_lo, m_hi]
    const int m_lo = max(0, j - (n_frames - 1));
    const int m_hi = min(r - 1, j);
    for (int u = threadIdx.x * kCols; u < hop; u += blockDim.x * kCols) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int m0 = m_lo; m0 <= m_hi; m0 += kMaxRatio) {
            // every term's loads first: frame j-m's run m*hop .. m*hop+hop
            // and the window's, at this thread's 4 samples
            float4 fv[kMaxRatio], wv[kMaxRatio];
#pragma unroll
            for (int k = 0; k < kMaxRatio; ++k) {
                const int m = m0 + k;
                if (m <= m_hi) {
                    const long long col = (long long)m * hop;
                    fv[k] = load4<VEC>(fb + (long long)(j - m) * frame_len + col, u, hop);
                    wv[k] = load4<VEC>(window + col, u, hop);
                }
            }
            // then the sum, m ascending
#pragma unroll
            for (int k = 0; k < kMaxRatio; ++k) {
                if (m0 + k <= m_hi) {
                    acc = mul_add4(acc, fv[k], wv[k]);
                }
            }
        }
        store4<VEC>(ob, u, hop, acc);
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
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
    store4<VEC>(out, c, frame_len, o);
}

// K1W's limits; the plan (ops/ola.py:window_plan) keeps within them
constexpr int kWindowThreads = 256;   // column lanes x row lanes of a block
constexpr int kWindowMaxCluster = 8;  // the portable cluster size
constexpr int kRowsInFlight = 4;      // rows whose loads a thread issues together
constexpr int kLanesInFlight = 8;     // row lanes whose partials a thread loads together
constexpr int kMaxSpins = 1 << 20;    // tries of the mbarrier before the kernel traps

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 acc) {
    return make_float4(fmaf(a.x, b.x, acc.x), fmaf(a.y, b.y, acc.y), fmaf(a.z, b.z, acc.z),
                       fmaf(a.w, b.w, acc.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the address in block `rank` of the cluster of this block's shared address `addr`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

template <bool VEC>
__global__ void __launch_bounds__(kWindowThreads)
ola_backward_window_kernel(const float* __restrict__ g, const float* __restrict__ frames,
                           float* __restrict__ g_window, int n_frames, int frame_len, int hop,
                           int rows, int tile_cols, int ranks, int rows_per_lane) {
    __shared__ float4 part[kWindowThreads];                         // one per thread
    __shared__ float4 incoming[kWindowThreads + kWindowMaxCluster];  // [rank][slice lane]
    __shared__ alignas(8) unsigned long long arrived;               // mbarrier of `incoming`
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const uint32_t arrived_addr = shared_addr(&arrived);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(arrived_addr) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every block's mbarrier is set before any peer stores to it: arrive
    // now, wait after the rows
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

    const int tile = blockIdx.x / ranks;
    const int col_lanes = tile_cols / kCols;
    const int col_lane = threadIdx.x % col_lanes;
    const int row_lane = threadIdx.x / col_lanes;
    const int row_lanes = blockDim.x / col_lanes;
    const int c = tile * tile_cols + col_lane * kCols;

    const long long q = (long long)rank * row_lanes + row_lane;
    const int r0 = (int)min((long long)rows, q * rows_per_lane);
    const int r1 = (int)min((long long)rows, (q + 1) * rows_per_lane);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < frame_len) {
        const long long total = (long long)(n_frames - 1) * hop + frame_len;
        int i = r0 % n_frames;
        const float* gp = g + (long long)(r0 / n_frames) * total + (long long)i * hop;
        const float* fp = frames + (long long)r0 * frame_len;
        for (int r = r0; r < r1; r += kRowsInFlight) {
            const int count = min(kRowsInFlight, r1 - r);
            float4 gv[kRowsInFlight], fv[kRowsInFlight];
#pragma unroll
            for (int k = 0; k < kRowsInFlight; ++k) {
                if (k < count) {
                    gv[k] = load4<VEC>(gp, c, frame_len);
                    fv[k] = load4<VEC>(fp, c, frame_len);
                    fp += frame_len;
                    gp += hop;
                    if (++i == n_frames) {  // the next batch row of g
                        i = 0;
                        gp += frame_len - hop;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kRowsInFlight; ++k) {
                if (k < count) {
                    acc = fma4(gv[k], fv[k], acc);
                }
            }
        }
    }

    // the block's row lanes, in lane order
    part[threadIdx.x] = acc;  // threadIdx.x == row_lane * col_lanes + col_lane
    __syncthreads();
    asm volatile("barrier.cluster.wait;" ::: "memory");
    const int slice = (col_lanes + ranks - 1) / ranks;  // column lanes each rank owns
    if (row_lane == 0) {
        for (int l0 = 1; l0 < row_lanes; l0 += kLanesInFlight) {
            float4 v[kLanesInFlight];
#pragma unroll
            for (int k = 0; k < kLanesInFlight; ++k) {
                if (l0 + k < row_lanes) {
                    v[k] = part[(l0 + k) * col_lanes + col_lane];
                }
            }
#pragma unroll
            for (int k = 0; k < kLanesInFlight; ++k) {
                if (l0 + k < row_lanes) {
                    acc = add4(acc, v[k]);
                }
            }
        }
        // to the rank that owns this column lane, into its slot for this rank
        const int owner = col_lane / slice;
        const uint32_t dst = peer_addr(shared_addr(&incoming[rank * slice + col_lane % slice]), owner);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
            ::"r"(dst), "f"(acc.x), "f"(acc.y), "f"(acc.z), "f"(acc.w),
            "r"(peer_addr(arrived_addr, owner)) : "memory");
    }
    const int owned = max(0, min(slice, col_lanes - rank * slice));
    if (threadIdx.x == 0) {  // the bytes every rank sends here
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(arrived_addr), "r"(ranks * owned * (int)sizeof(float4)) : "memory");
    }
    // this rank's column lanes: every rank's partial, added in rank order
    if (threadIdx.x < owned) {
        uint32_t done = 0;
        for (int spin = 0; !done; ++spin) {
            asm volatile(
                "{\n .reg .pred p;\n"
                " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
                " selp.u32 %0, 1, 0, p;\n}"
                : "=r"(done) : "r"(arrived_addr) : "memory");
            if (spin == kMaxSpins) {
                __trap();  // a wait that could not end would hang the card
            }
        }
        const int out_col = tile * tile_cols + (rank * slice + threadIdx.x) * kCols;
        if (out_col < frame_len) {
            float4 v[kWindowMaxCluster];
#pragma unroll
            for (int k = 0; k < kWindowMaxCluster; ++k) {
                if (k < ranks) {
                    v[k] = incoming[k * slice + threadIdx.x];
                }
            }
            float4 s = v[0];
#pragma unroll
            for (int k = 1; k < kWindowMaxCluster; ++k) {
                if (k < ranks) {
                    s = add4(s, v[k]);
                }
            }
            store4<VEC>(g_window, out_col, frame_len, s);
        }
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
    const int lanes = (hop + kCols - 1) / kCols;  // a hop-tile's 4-sample lanes
    const int threads = lanes < kThreads ? ((lanes + 31) / 32) * 32 : kThreads;
    const bool vec = hop % kCols == 0 && frame_len % kCols == 0 && aligned16(frames) &&
                     aligned16(window) && aligned16(out);
    if (vec) {
        windowed_ola_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const float*)frames, (const float*)window, (float*)out, n_frames, frame_len, hop);
    } else {
        windowed_ola_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const float*)frames, (const float*)window, (float*)out, n_frames, frame_len, hop);
    }
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

extern "C" int ola_backward_window_launch(const void* g, const void* frames, void* g_window,
                                          int batch, int n_frames, int frame_len, int hop,
                                          int tile_cols, int row_lanes, int cluster,
                                          int rows_per_lane, void* stream) {
    if (batch <= 0 || n_frames <= 0 || hop <= 0 || frame_len % hop != 0 || tile_cols <= 0 ||
        tile_cols % kCols != 0 || row_lanes <= 0 || cluster <= 0 ||
        cluster > kWindowMaxCluster || rows_per_lane <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const long long rows = (long long)batch * n_frames;
    const long long threads = (long long)(tile_cols / kCols) * row_lanes;
    const long long tiles = (frame_len + (long long)tile_cols - 1) / tile_cols;
    // the plan must fit a block, its lanes cover the rows, and the grid fit grid.x
    if (rows > 0x7fffffffLL || threads > kWindowThreads ||
        (long long)cluster * row_lanes * rows_per_lane < rows || tiles * cluster > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * cluster));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const bool vec = hop % kCols == 0 && frame_len % kCols == 0 && aligned16(g) &&
                     aligned16(frames) && aligned16(g_window);
    void (*kernel)(const float*, const float*, float*, int, int, int, int, int, int, int) =
        vec ? ola_backward_window_kernel<true> : ola_backward_window_kernel<false>;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const float*)g, (const float*)frames,
                                               (float*)g_window, n_frames, frame_len, hop,
                                               (int)rows, tile_cols, cluster, rows_per_lane);
    if (err != cudaSuccess) {
        cudaGetLastError();  // a refused launch must not stay behind as the next call's error
        return (int)err;
    }
    return (int)cudaGetLastError();
}
