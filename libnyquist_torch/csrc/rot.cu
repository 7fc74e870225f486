/* CELT spreading rotation (celt/vq.c exp_rotation, decode direction) over
 * the whole raw-iy leaf plane, as a CUDA kernel for Hopper (sm_90a).
 *
 * Replaces the reference package's Pallas TPU kernel _rot_kernel
 * (ops/rot_pallas.py, wrapper rotate_plane_pallas). Same math as the
 * plain version rotate_plane_ref in ops/rot.py, in four steps:
 *
 *   1. fill the sparse sub-segment markers (pk / theta / gain) forward
 *      along the position axis;
 *   2. per position: validity (inside its marker's sub-segment), the
 *      segment key, the lag class, cos/sin(pi/2 * theta), the gain;
 *   3. per sigma class, from its first possible column `lo`: the forward
 *      and the backward Givens sweep of exp_rotation1 at stride sigma
 *      with swapped coefficients (vq.c:100), then both sweeps at lag 1;
 *      a step acts only where both ends lie in one sub-segment;
 *   4. the per-leaf gain.
 *
 * Planes are position-major [W, R]: W positions (800 for 20 ms frames),
 * R = channel * frames + frame rows. pk packs, per marker,
 * column << 13 | sub-segment length << 4 | lag, lag = 1 + sigma for a
 * rotating sub-segment and 1 otherwise; -1 means no marker.
 *
 * Design. The TPU kernel holds a [W, 128] strip in on-chip memory and
 * advances one sublane per step because its vector unit cannot index per
 * lane; none of that carries over. Every sweep is a recurrence along
 * position with a data-dependent predicate per step, and the rows are
 * independent, so one thread owns one row and walks the positions in
 * order. With the planes position-major the 32 rows of a warp read 32
 * adjacent floats at each position, so every access coalesces. The
 * per-row working state (segment key, cos, sin, gain: four values per
 * position) does not fit in registers at W = 800; it lives in global
 * scratch planes of the same layout, which the wrapper allocates. The
 * sweeps run in place on y. A step whose predicate is false touches
 * only the two keys. The lag class is recomputed from the key (its low
 * four bits) instead of being stored.
 *
 * What bounds it on an H100: bytes, in principle. The function must read
 * x and the three marker planes and write y once: 5 * W * R * 4 bytes
 * (355 MB for one stream of 22,200 rows, about 0.11 ms at 3.35 TB/s).
 * This kernel moves far more: each of the 2 * (classes + 1) sweeps
 * streams the key, coefficient and value planes again, and each step of
 * a row's chain waits for the loads of the step before it, so it is
 * latency-bound with one thread per row (22,200 threads on a card that
 * holds 270,336). Staging a block of rows in shared memory and splitting
 * a sweep across lanes is work for a later change.
 */
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CLASSES 16
#define ROT_THREADS 128

struct RotClasses {
    int n;                     /* sigma classes, then the lag-1 class */
    int sigma[MAX_CLASSES];
    int lo[MAX_CLASSES];
};

/* lag class of a filled key: low four bits of a valid marker, 0 for a
 * position outside every sub-segment (those keys are negative) */
__device__ __forceinline__ int lag_of(int key)
{
    return key >= 0 ? (key & 15) : 0;
}

__global__ void __launch_bounds__(ROT_THREADS)
rot_kernel(const float *__restrict__ x, const int *__restrict__ pk,
           const float *__restrict__ th, const float *__restrict__ g,
           float *__restrict__ y, int *__restrict__ key,
           float *__restrict__ cs, float *__restrict__ sn,
           float *__restrict__ gm, int W, long long R, RotClasses cls)
{
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R)
        return;
    const float half_pi = 1.57079632679489661923f;

    /* 1 + 2: fill forward, derive the per-position planes */
    int kf = -1;
    float tf = 0.0f, gf = 0.0f;
    for (int i = 0; i < W; ++i) {
        const long long o = (long long)i * R + r;
        const int p = pk[o];
        if (p >= 0) {
            kf = p;
            tf = th[o];
            gf = g[o];
        }
        const bool valid = kf >= 0 && (i - (kf >> 13)) < ((kf >> 4) & 0x1FF);
        const bool on = valid && tf > 0.0f;
        key[o] = valid ? kf : -1 - i;
        cs[o] = on ? cosf(half_pi * tf) : 1.0f;
        sn[o] = on ? sinf(half_pi * tf) : 0.0f;
        gm[o] = valid ? gf : 1.0f;
        y[o] = x[o];
    }

    /* 3: the sweeps, in exp_rotation1's scalar order */
    for (int c = 0; c < cls.n; ++c) {
        const int sg = cls.sigma[c];
        const int lo = cls.lo[c];
        const bool last = c == cls.n - 1;          /* the lag-1 class */
        const long long d = (long long)sg * R;

        for (int i = lo; i < W - sg; ++i) {
            const long long o = (long long)i * R + r;
            const int k1 = key[o];
            const int lg = lag_of(k1);
            if (k1 == key[o + d] && (last ? lg > 0 : lg == 1 + sg)) {
                const float cc = last ? cs[o] : sn[o];
                const float ss = last ? sn[o] : cs[o];
                const float x1 = y[o], x2 = y[o + d];
                y[o + d] = cc * x2 + ss * x1;
                y[o] = cc * x1 - ss * x2;
            }
        }
        for (int i = W - 2 * sg - 1; i >= lo; --i) {
            const long long o = (long long)i * R + r;
            const int k1 = key[o];
            const int lg = lag_of(k1);
            if (k1 == key[o + 2 * d] && (last ? lg > 0 : lg == 1 + sg)) {
                const float cc = last ? cs[o] : sn[o];
                const float ss = last ? sn[o] : cs[o];
                const float x1 = y[o], x2 = y[o + d];
                y[o + d] = cc * x2 + ss * x1;
                y[o] = cc * x1 - ss * x2;
            }
        }
    }

    /* 4: per-leaf gain */
    for (int i = 0; i < W; ++i) {
        const long long o = (long long)i * R + r;
        y[o] *= gm[o];
    }
}

/* Launch on `stream`; returns cudaGetLastError() (0 on success), or
 * cudaErrorInvalidValue for more than MAX_CLASSES - 1 sigma classes.
 * x, th, g, y, cs, sn, gm are device float [W, R]; pk, key device int32
 * [W, R]; key, cs, sn, gm are scratch. sigmas / los are HOST arrays of
 * n_sigma entries: the sigma classes and the first column of each. The
 * lag-1 class is appended here. */
extern "C" int rotate_plane_launch(
    const float *x, const int *pk, const float *th, const float *g,
    float *y, int *key, float *cs, float *sn, float *gm,
    int W, long long R, const int *sigmas, const int *los, int n_sigma,
    void *stream)
{
    RotClasses cls;
    if (n_sigma < 0 || n_sigma > MAX_CLASSES - 1)
        return (int)cudaErrorInvalidValue;
    for (int c = 0; c < n_sigma; ++c) {
        cls.sigma[c] = sigmas[c];
        cls.lo[c] = los[c];
    }
    cls.sigma[n_sigma] = 1;
    cls.lo[n_sigma] = 0;
    cls.n = n_sigma + 1;
    const long long blocks = (R + ROT_THREADS - 1) / ROT_THREADS;
    rot_kernel<<<(unsigned)blocks, ROT_THREADS, 0, (cudaStream_t)stream>>>(
        x, pk, th, g, y, key, cs, sn, gm, W, R, cls);
    return (int)cudaGetLastError();
}
