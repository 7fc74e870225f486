/* CELT pitch postfilter (celt/celt.c comb_filter) as a CUDA kernel for
 * Hopper (sm_90a).
 *
 * Replaces the reference package's Pallas TPU kernel _comb_kernel
 * (ops/comb_pallas.py, wrapper comb_filter_stream_pallas). Same math as
 * the plain version comb_filter_stream_ref in ops/comb.py:
 *
 *   y[i] = x[i] + (1 - f[i]) * taps(g0, T0) + f[i] * taps(g1, T1)
 *   taps(g, T) = g0*y[i-T] + g1*(y[i-T-1] + y[i-T+1])
 *                          + g2*(y[i-T-2] + y[i-T+2])
 *
 * where y before the segment is the carried history (HIST = 1026
 * samples), the lag T in [15, 1024] and the gains change per 12-sample
 * chunk, and f is the squared-window crossfade.
 *
 * Design. The TPU kernel splits each lag read into a coarse 8-row group
 * sum and a fine in-vreg rotate because its vector unit cannot gather
 * across sublanes; a GPU lane gathers from shared memory natively, so
 * none of that carries over. One warp owns one row: lanes 0..11 each own
 * one sample of the current chunk, the filtered history is a 2048-float
 * ring in shared memory seeded from hist, and the row advances one chunk
 * at a time. Since T >= 15 > CHUNK + 2, no read in a chunk touches a
 * sample written in the same chunk, so the only ordering needed is one
 * __syncwarp per chunk. The ring is indexed modulo its size, so any lag
 * stays inside it. The next chunk's inputs are loaded into registers
 * before the current chunk's ring reads, which hides most of the global
 * load latency behind the chain.
 *
 * What bounds it on an H100: not bytes. At the serving shape (16 rows,
 * 491,520 samples per row per step) x and y are ~63 MB and the fade,
 * gains and lags ~52 MB, about 35 us at 3.35 TB/s. The chain of 40,960
 * dependent chunks per row sets the pace, with only one warp per row
 * live (16 warps on 132 SMs): the kernel is latency-bound on a shared
 * memory round trip plus a warp barrier per chunk. Splitting a row's
 * chain (e.g. a block-parallel prefix over frames with the history as
 * the carry) is work for a later change.
 */
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 12
#define HIST 1026
#define RING 2048
#define RMASK (RING - 1)

struct ChunkIn {
    int t0, t1;
    float a0, a1, a2, b0, b1, b2;
    float x, f;
};

__device__ __forceinline__ ChunkIn load_chunk(
    const int *__restrict__ T0, const int *__restrict__ T1,
    const float *__restrict__ g0, const float *__restrict__ g1,
    const float *__restrict__ fade, const float *__restrict__ x,
    long long k, int lane)
{
    ChunkIn c;
    c.t0 = T0[k];
    c.t1 = T1[k];
    c.a0 = g0[3 * k];
    c.a1 = g0[3 * k + 1];
    c.a2 = g0[3 * k + 2];
    c.b0 = g1[3 * k];
    c.b1 = g1[3 * k + 1];
    c.b2 = g1[3 * k + 2];
    c.f = fade[CHUNK * k + lane];
    c.x = x[CHUNK * k + lane];
    return c;
}

__global__ void __launch_bounds__(32)
comb_kernel(const float *__restrict__ x, const float *__restrict__ hist,
            const int *__restrict__ T0, const int *__restrict__ T1,
            const float *__restrict__ g0, const float *__restrict__ g1,
            const float *__restrict__ fade, float *__restrict__ y,
            long long n_chunks)
{
    __shared__ float ring[RING];
    const long long row = blockIdx.x;
    const int lane = threadIdx.x;
    const long long S = n_chunks * CHUNK;

    /* ring position p holds stream sample p - HIST (history first) */
    for (int i = lane; i < HIST; i += 32)
        ring[i] = hist[row * HIST + i];
    __syncwarp();
    if (lane >= CHUNK)
        return;
    const unsigned mask = (1u << CHUNK) - 1u;

    x += row * S;
    y += row * S;
    fade += row * S;
    T0 += row * n_chunks;
    T1 += row * n_chunks;
    g0 += row * n_chunks * 3;
    g1 += row * n_chunks * 3;

    ChunkIn cur = load_chunk(T0, T1, g0, g1, fade, x, 0, lane);
    /* unsigned positions: wrap-around at 2^32 is a multiple of RING */
    unsigned q = HIST + lane;
    for (long long k = 0; k < n_chunks; ++k, q += CHUNK) {
        ChunkIn nxt = cur;
        if (k + 1 < n_chunks)
            nxt = load_chunk(T0, T1, g0, g1, fade, x, k + 1, lane);

        const unsigned p0 = q - (unsigned)cur.t0;
        const unsigned p1 = q - (unsigned)cur.t1;
        const float old = cur.a0 * ring[p0 & RMASK]
            + cur.a1 * (ring[(p0 - 1) & RMASK] + ring[(p0 + 1) & RMASK])
            + cur.a2 * (ring[(p0 - 2) & RMASK] + ring[(p0 + 2) & RMASK]);
        const float neu = cur.b0 * ring[p1 & RMASK]
            + cur.b1 * (ring[(p1 - 1) & RMASK] + ring[(p1 + 1) & RMASK])
            + cur.b2 * (ring[(p1 - 2) & RMASK] + ring[(p1 + 2) & RMASK]);
        const float yv = cur.x + (1.0f - cur.f) * old + cur.f * neu;
        ring[q & RMASK] = yv;
        y[CHUNK * k + lane] = yv;
        __syncwarp(mask);
        cur = nxt;
    }
}

/* Launch on `stream`; returns cudaGetLastError() (0 on success). All
 * pointers are device pointers to contiguous arrays:
 *   x, y [B, S]; hist [B, 1026]; T0, T1 [B, n_chunks] int32;
 *   g0, g1 [B, n_chunks, 3]; fade [B, n_chunks, 12]; S = 12 * n_chunks. */
extern "C" int comb_filter_launch(
    const float *x, const float *hist, const int *T0, const int *T1,
    const float *g0, const float *g1, const float *fade, float *y,
    int B, long long n_chunks, void *stream)
{
    comb_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        x, hist, T0, T1, g0, g1, fade, y, n_chunks);
    return (int)cudaGetLastError();
}
