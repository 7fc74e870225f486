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
 * chunk, and f is the squared-window crossfade. The steps it takes are
 * the ones comb_step_plan states in ops/comb.py, and
 * comb_filter_planned_ref there is this algorithm in plain PyTorch.
 *
 * What bounds it on an H100: not bytes (115 MB at the serving shape of
 * 16 rows x 491,520 samples, 0.034 ms at 3.35 TB/s) but the row's chain:
 * a sample needs filtered samples at least 13 and at most 1026 places
 * before it, so a row is a chain of dependent steps, each a round trip
 * through shared memory (store, block barrier, dependent load) plus the
 * step's own arithmetic. With 16 rows
 * only 16 of the 132 SMs have work, so what counts is the length of a
 * step's critical path and the number of steps.
 *
 * Design: one block of 128 threads per row, one sample per thread per
 * step, the filtered history a 2048-float ring in shared memory (stream
 * sample s at ring[s mod 2048], its first four entries mirrored past the
 * end so that a 5-tap window is one masked base and five fixed offsets).
 *   1. Inputs staged ahead of the chain. The row's x, fade, lags and
 *      gains come in tiles of TILE = 256 chunks (32 KB) through 16-byte
 *      cp.async copies, NSTAGE = 3 tiles deep: the block requests tile
 *      t + 2 before it works on tile t, so the chain reads shared memory
 *      only and never waits on device memory.
 *   2. Wide steps. The only ordering rule is that a step may not read a
 *      sample it writes. A step of m chunks is legal when every chunk in
 *      it that filters at all has min(T0, T1) >= 12 m + 2; a chunk whose
 *      six gains are zero is y = x and limits nothing. Per tile the
 *      block computes each chunk's limit and the longest legal step from
 *      each chunk (at most MAX_STEP = 10 chunks, 120 samples, never
 *      across a tile's end); the chain then walks k += width[k]. The
 *      staged lags of a chunk that does not filter are set to 1024, so
 *      the chain has no branch for it: its taps read old samples, times
 *      zero.
 *   3. A short critical path per step. A thread holds its sample's lags,
 *      gains, x and fade in registers before the step begins: the
 *      parameters of the next step (and its width) are loaded while the
 *      ring reads of this one are in flight. What remains in the chain
 *      is ring load, eleven multiply-adds in the plain version's order,
 *      ring store, one __syncthreads.
 *   4. y is stored from the step itself: the step's threads write
 *      neighbouring floats, one coalesced store a warp, and nothing waits
 *      for it.
 * Rows whose chunk count is no multiple of 4 (their lag and gain rows
 * then start off 16 bytes) are staged with 4-byte copies.
 *
 * Not taken: restart points (cutting a row where the gains are zero for
 * 1026 samples or more). On the serving corpus no real frame has all its
 * gains zero, so there is nothing to cut at.
 */
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 12
#define HIST 1026
#define MAXPERIOD 1024
#define RING 2048
#define RMASK (RING - 1)
#define MIRROR 4
#define NT 128                    /* threads per row */
#define TILE 256                  /* chunks per staged tile */
#define TSAMP (TILE * CHUNK)      /* samples per tile */
#define NSTAGE 3
#define MAX_STEP 10               /* chunks; MAX_STEP * CHUNK <= NT */

struct Stage {                    /* every member a multiple of 16 bytes */
    float x[TSAMP];
    float f[TSAMP];
    float g0[3 * TILE];
    float g1[3 * TILE];
    int t0[TILE];
    int t1[TILE];
};

struct Smem {
    Stage st[NSTAGE];
    float ring[RING + MIRROR];
    unsigned char lim[TILE];              /* widest step a chunk allows */
    unsigned char width[TILE];            /* longest legal step from it */
};

/* one sample's inputs */
struct Params {
    int t0, t1;
    float a0, a1, a2, b0, b1, b2, x, f;
};

__device__ __forceinline__ void cp_async16(void *dst, const void *src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void *dst, const void *src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

/* Copy `count` 4-byte words from src to dst, the whole block, 16 or 4
 * bytes a copy. With vec, count is a multiple of 4 and both ends are
 * aligned. */
__device__ __forceinline__ void stage_words(void *dst, const void *src,
                                            int count, int tid, bool vec)
{
    if (vec) {
        for (int i = tid; i < (count >> 2); i += NT)
            cp_async16((char *)dst + 16 * i, (const char *)src + 16 * i);
    } else {
        for (int i = tid; i < count; i += NT)
            cp_async4((char *)dst + 4 * i, (const char *)src + 4 * i);
    }
}

/* The inputs of the sample `tid` places into the step that starts at
 * chunk k of the stage; indices past the stage are clamped (such a
 * thread is past the step's end and stores nothing). */
__device__ __forceinline__ Params load_params(const Stage &st, int k,
                                              int cj, int tid)
{
    const int c = min(k + cj, TILE - 1);
    const int js = min(CHUNK * k + tid, TSAMP - 1);
    Params p;
    p.t0 = st.t0[c];
    p.t1 = st.t1[c];
    p.a0 = st.g0[3 * c];
    p.a1 = st.g0[3 * c + 1];
    p.a2 = st.g0[3 * c + 2];
    p.b0 = st.g1[3 * c];
    p.b1 = st.g1[3 * c + 1];
    p.b2 = st.g1[3 * c + 2];
    p.x = st.x[js];
    p.f = st.f[js];
    return p;
}

__global__ void __launch_bounds__(NT)
comb_kernel(const float *__restrict__ x, const float *__restrict__ hist,
            const int *__restrict__ T0, const int *__restrict__ T1,
            const float *__restrict__ g0, const float *__restrict__ g1,
            const float *__restrict__ fade, float *__restrict__ y,
            long long n_chunks, int vec,
            long long *__restrict__ steps_out)
{
    extern __shared__ __align__(16) unsigned char comb_smem[];
    Smem &S = *reinterpret_cast<Smem *>(comb_smem);
    const long long row = blockIdx.x;
    const int tid = threadIdx.x;
    const int cj = tid / CHUNK;   /* chunk of this thread's sample in a step */
    const long long NS = n_chunks * CHUNK;

    x += row * NS;
    y += row * NS;
    fade += row * NS;
    T0 += row * n_chunks;
    T1 += row * n_chunks;
    g0 += row * n_chunks * 3;
    g1 += row * n_chunks * 3;

    const long long n_tiles = (n_chunks + TILE - 1) / TILE;

    auto fetch_tile = [&](long long t) {
        if (t < n_tiles) {
            Stage &st = S.st[t % NSTAGE];
            const long long k0 = t * TILE;
            const int cnt = (int)min((long long)TILE, n_chunks - k0);
            stage_words(st.x, x + CHUNK * k0, CHUNK * cnt, tid, vec);
            stage_words(st.f, fade + CHUNK * k0, CHUNK * cnt, tid, vec);
            stage_words(st.g0, g0 + 3 * k0, 3 * cnt, tid, vec);
            stage_words(st.g1, g1 + 3 * k0, 3 * cnt, tid, vec);
            stage_words(st.t0, T0 + k0, cnt, tid, vec);
            stage_words(st.t1, T1 + k0, cnt, tid, vec);
        }
        cp_async_commit();        /* one group per tile, empty past the end */
    };

    for (int t = 0; t < NSTAGE - 1; ++t)
        fetch_tile(t);

    /* the ring: zeros, then the history as stream samples -HIST .. -1 */
    for (int i = tid; i < RING + MIRROR; i += NT)
        S.ring[i] = 0.0f;
    __syncthreads();
    for (int i = tid; i < HIST; i += NT)
        S.ring[RING - HIST + i] = hist[row * HIST + i];

    long long steps = 0;
    for (long long t = 0; t < n_tiles; ++t) {
        fetch_tile(t + NSTAGE - 1);
        cp_async_wait<NSTAGE - 1>();      /* this thread's part of tile t */
        __syncthreads();                  /* and every other thread's */
        Stage &st = S.st[t % NSTAGE];
        const int cnt = (int)min((long long)TILE, n_chunks - t * TILE);

        /* the widest step each chunk allows; a chunk that does not
         * filter reads far back, where nothing is being written */
        for (int c = tid; c < cnt; c += NT) {
            int l = MAX_STEP;
            const bool act = st.g0[3 * c] != 0.0f
                || st.g0[3 * c + 1] != 0.0f || st.g0[3 * c + 2] != 0.0f
                || st.g1[3 * c] != 0.0f || st.g1[3 * c + 1] != 0.0f
                || st.g1[3 * c + 2] != 0.0f;
            if (act) {
                l = max(1, min((min(st.t0[c], st.t1[c]) - 2) / CHUNK,
                               MAX_STEP));
            } else {
                st.t0[c] = MAXPERIOD;
                st.t1[c] = MAXPERIOD;
            }
            S.lim[c] = (unsigned char)l;
        }
        __syncthreads();
        /* the longest legal step from each chunk */
        for (int c = tid; c < cnt; c += NT) {
            const int room = min(cnt - c, MAX_STEP);
            int run = MAX_STEP, m = 1;
            for (int j = 0; j < room; ++j) {
                run = min(run, (int)S.lim[c + j]);
                if (run < j + 1)
                    break;
                m = j + 1;
            }
            S.width[c] = (unsigned char)m;
        }
        __syncthreads();

        /* the chain over this tile; unsigned sample positions wrap at
         * 2^32, a multiple of RING */
        const unsigned q0 = (unsigned)(t * TSAMP) + (unsigned)tid;
        float *yt = y + t * TSAMP + tid;
        int k = 0;
        int m = S.width[0];
        Params p = load_params(st, 0, cj, tid);
        while (k < cnt) {
            const int kn = k + m;
            const int mn = kn < cnt ? (int)S.width[kn] : 1;
            const unsigned q = q0 + (unsigned)(CHUNK * k);
            const float *w0 = &S.ring[(q - (unsigned)p.t0 - 2u) & RMASK];
            const float *w1 = &S.ring[(q - (unsigned)p.t1 - 2u) & RMASK];
            const float r0 = w0[0], r1 = w0[1], r2 = w0[2], r3 = w0[3],
                        r4 = w0[4];
            const float s0 = w1[0], s1 = w1[1], s2 = w1[2], s3 = w1[3],
                        s4 = w1[4];
            const Params pn = load_params(st, kn, cj, tid);
            const float old = p.a0 * r2 + p.a1 * (r1 + r3) + p.a2 * (r0 + r4);
            const float neu = p.b0 * s2 + p.b1 * (s1 + s3) + p.b2 * (s0 + s4);
            const float yv = p.x + (1.0f - p.f) * old + p.f * neu;
            if (tid < CHUNK * m) {
                const unsigned idx = q & RMASK;
                S.ring[idx] = yv;
                if (idx < MIRROR)
                    S.ring[idx + RING] = yv;
                yt[CHUNK * k] = yv;
            }
            __syncthreads();
            k = kn;
            m = mn;
            p = pn;
            ++steps;
        }
    }
    if (steps_out != nullptr && tid == 0)
        steps_out[row] = steps;
}

/* Launch on `stream`; returns cudaGetLastError() (0 on success). All
 * pointers are device pointers to contiguous arrays:
 *   x, y [B, S]; hist [B, 1026]; T0, T1 [B, n_chunks] int32;
 *   g0, g1 [B, n_chunks, 3]; fade [B, n_chunks, 12]; S = 12 * n_chunks.
 * x, y and fade are 16-byte aligned. vec != 0 promises that T0, T1, g0
 * and g1 are too and that n_chunks is a multiple of 4. steps_out, when
 * not null, receives the steps each row's chain took ([B] int64). */
extern "C" int comb_filter_launch(
    const float *x, const float *hist, const int *T0, const int *T1,
    const float *g0, const float *g1, const float *fade, float *y,
    int B, long long n_chunks, int vec, long long *steps_out, void *stream)
{
    cudaError_t e = cudaFuncSetAttribute(
        comb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess)
        return (int)e;
    comb_kernel<<<B, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, hist, T0, T1, g0, g1, fade, y, n_chunks, vec, steps_out);
    return (int)cudaGetLastError();
}
