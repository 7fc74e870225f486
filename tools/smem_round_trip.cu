/* Probe: the cycles of one round trip of a thread block through shared
 * memory on the card: store, block barrier, load of what a thread of
 * another warp stored, one add. This is the unit the pitch postfilter's
 * chain (libnyquist_torch/csrc/comb.cu: 128 threads a row, one
 * __syncthreads a step) is counted in; chip_smoke.py builds this file
 * and turns the postfilter's step counts into a chain bound with it. No
 * part of the package.
 *
 *   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
 *        -Xcompiler -fPIC -o libsmem_round_trip.so smem_round_trip.cu
 */
#include <cuda_runtime.h>

#define MAX_THREADS 1024

/* out[0] = clock cycles of `iters` round trips, out[1] keeps the value
 * alive. Two halves alternate, so that one barrier a trip is enough, as
 * in the filter. */
__global__ void round_trip_kernel(long long *out, int iters)
{
    __shared__ float buf[2 * MAX_THREADS];
    const int n = blockDim.x;
    const int t = threadIdx.x;
    const int to = (t + 32) % n;          /* a thread of the next warp */
    buf[t] = (float)t;
    buf[t + n] = 0.0f;
    __syncthreads();
    float v = buf[t];
    const long long c0 = clock64();
    for (int i = 0; i < iters; ++i) {
        float *half = buf + n * (i & 1);
        half[to] = v + 1.0f;
        __syncthreads();
        v = half[t];
    }
    const long long c1 = clock64();
    if (t == 0) {
        out[0] = c1 - c0;
        out[1] = (long long)v;
    }
}

/* One block of `threads` threads (a multiple of 32, at most 1024) on
 * `stream`; out is a device int64[2]. Returns cudaGetLastError(). */
extern "C" int smem_round_trip_launch(long long *out, int iters, int threads,
                                      void *stream)
{
    if (threads < 32 || threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    round_trip_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, iters);
    return (int)cudaGetLastError();
}
