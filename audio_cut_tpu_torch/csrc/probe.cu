// K0: the build-and-launch check of the port's kernel library.
//
// Replaces the TPU kernel audio_cut_tpu/ops/pallas/probe.py (the pallas_call
// inside _PROBE_CODE): x * 2 on one (8, 128) float32 tile. There the kernel
// decided whether Pallas ran at all; here ops/cuda.py builds and launches it
// once per process before it loads any other kernel library, and raises if
// the result is not exactly x * 2 or the launch reports a CUDA error. Nothing
// switches to a plain version.
//
// Bound: memory, 4 KB in and 4 KB out; the launch itself costs far more.
// Design: one block, one element per thread, a grid-stride loop for any n.

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        y[i] = x[i] * 2.0f;
    }
}

}  // namespace

extern "C" int probe_launch(const void* x, void* y, int n, void* stream) {
    if (n <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads < 1024 ? (n + threads - 1) / threads : 1024;
    probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
    return (int)cudaGetLastError();
}
