/* CELT spreading rotation (celt/vq.c exp_rotation, decode direction) over
 * the whole raw-iy leaf plane, as a CUDA kernel for Hopper (sm_90a).
 *
 * Replaces the reference package's Pallas TPU kernel _rot_kernel
 * (ops/rot_pallas.py, wrapper rotate_plane_pallas). Same function as the
 * plain version rotate_plane_ref in ops/rot.py; the algorithm is the one
 * rotate_rows_segments_ref states in plain PyTorch.
 *
 * Planes are row-major, as the replay's heap scatter builds them: rows
 * c * F + f, positions along the fast axis. x is [R, nmax] with a row
 * stride; the marker planes pk / th / g are [R, W] (W = 100 << LM band
 * positions, W <= nmax). pk packs, per marker,
 * column << 13 | sub-segment length << 4 | lag, lag = 1 + sigma for a
 * rotating sub-segment and 1 otherwise; -1 means no marker. y is a full
 * [R, nmax] plane: columns W .. nmax pass through.
 *
 * What the function really is: every marker opens one sub-segment, and
 * every sub-segment is an independent small problem. Its positions run
 * from the marker to the next marker of the row (a later marker cuts an
 * earlier sub-segment short), to the marker's own column + length, or to
 * W, whichever comes first. On it: exp_rotation1 at stride sigma with
 * swapped coefficients (vq.c:100), exp_rotation1 at stride 1, then the
 * leaf's gain. Positions in no sub-segment pass through unscaled.
 *
 * Design: a warp per row, a lane per sub-segment, the row in shared
 * memory.
 *   1. The warp copies the row's W values into shared memory with 16-byte
 *      loads and streams columns W .. nmax straight to y.
 *   2. It reads the row of pk with 16-byte loads and compacts the marker
 *      positions, in order, into a 16-bit list in shared memory (four
 *      ballots and prefix counts per 128 positions).
 *   3. Markers are dealt to lanes round-robin. A lane fetches its
 *      marker's pk, theta and gain (theta and gain are read only at
 *      markers, so most of their planes never leaves device memory),
 *      takes cosf / sinf once, and runs the sweeps of its sub-segment on
 *      the shared row in exp_rotation1's scalar order. The lag-1 sweeps
 *      carry the running value in a register, so each step is one load,
 *      one store and four multiply-adds, in the order of the plain
 *      version.
 *   4. The warp writes the row back with 16-byte stores.
 * No global scratch, and no transposes around the call: the working
 * state of a sub-segment is a handful of registers.
 *
 * Why round-robin and no finer split: on a real stream (22,200 rows) a
 * row has 45 markers on average and 119 at most, the longest rotating
 * sub-segment has 88 values (322 Givens steps), and the slowest lane of
 * a row has about 106 steps and gain products against 23 for a perfect
 * split. That is a few microseconds a row with some forty rows resident
 * on each SM, below the time the row's bytes take; splitting a stride-
 * sigma sweep over sigma lanes would buy nothing that shows.
 *
 * What bounds it on an H100: bytes. x in and y out ([R, nmax] each) and
 * the pk plane are read or written once; theta and gain only in the
 * 32-byte sectors that hold a marker. The bound the records use counts
 * just that: (2 * nmax + W) * R * 4 bytes plus 8 bytes (theta and gain)
 * per marker, about 250 MB for a stream of 22,200 rows of 960 values
 * with a million markers, 0.075 ms at 3.35 TB/s.
 */
#include <cuda_runtime.h>
#include <stdint.h>

#define ROT_WARPS 8

/* One Givens step of exp_rotation1 on shared memory. */
__device__ __forceinline__ void givens(float *s, int i, int d, float c,
                                       float sn)
{
    const float x1 = s[i], x2 = s[i + d];
    s[i + d] = c * x2 + sn * x1;
    s[i] = c * x1 - sn * x2;
}

__global__ void __launch_bounds__(ROT_WARPS * 32)
rot_rows_kernel(const float *__restrict__ x, long long x_stride,
                const int *__restrict__ pk, const float *__restrict__ th,
                const float *__restrict__ g, float *__restrict__ y,
                int W, int nmax, long long R, unsigned sigma_mask,
                int warp_bytes)
{
    extern __shared__ __align__(16) unsigned char rot_smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long r = (long long)blockIdx.x * ROT_WARPS + warp;
    if (r >= R)
        return;               /* whole warps only; no block barrier below */
    float *v = reinterpret_cast<float *>(rot_smem + (size_t)warp * warp_bytes);
    unsigned short *mpos = reinterpret_cast<unsigned short *>(v + W);
    const unsigned lt = (1u << lane) - 1u;

    const float4 *x4 = reinterpret_cast<const float4 *>(x + r * x_stride);
    float4 *y4 = reinterpret_cast<float4 *>(y + r * (long long)nmax);
    const int W4 = W >> 2, N4 = nmax >> 2;

    /* 1: the row into shared memory, the tail straight through */
    for (int i = lane; i < W4; i += 32)
        reinterpret_cast<float4 *>(v)[i] = x4[i];
    for (int i = W4 + lane; i < N4; i += 32)
        y4[i] = x4[i];

    /* 2: compact the marker positions, in position order */
    const int *pkr = pk + r * (long long)W;
    const int4 *pk4 = reinterpret_cast<const int4 *>(pkr);
    int M = 0;
    for (int base = 0; base < W; base += 128) {
        const int p = base + 4 * lane;
        int4 q = make_int4(-1, -1, -1, -1);
        if (p < W)
            q = pk4[p >> 2];
        const unsigned b0 = __ballot_sync(0xffffffffu, q.x >= 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, q.y >= 0);
        const unsigned b2 = __ballot_sync(0xffffffffu, q.z >= 0);
        const unsigned b3 = __ballot_sync(0xffffffffu, q.w >= 0);
        int o = M + __popc(b0 & lt) + __popc(b1 & lt) + __popc(b2 & lt)
            + __popc(b3 & lt);
        if (q.x >= 0) mpos[o++] = (unsigned short)p;
        if (q.y >= 0) mpos[o++] = (unsigned short)(p + 1);
        if (q.z >= 0) mpos[o++] = (unsigned short)(p + 2);
        if (q.w >= 0) mpos[o++] = (unsigned short)(p + 3);
        M += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
    __syncwarp();

    /* 3: a lane per sub-segment */
    const float half_pi = 1.57079632679489661923f;
    const float *thr = th + r * (long long)W;
    const float *gr = g + r * (long long)W;
    for (int m = lane; m < M; m += 32) {
        const int p = mpos[m];
        const int nxt = (m + 1 < M) ? (int)mpos[m + 1] : W;
        const int key = pkr[p];
        const float tf = thr[p], gf = gr[p];
        /* valid positions: p <= i < nxt with i - column < length */
        const int L = min(max((key >> 13) + ((key >> 4) & 0x1FF) - p, 0),
                          nxt - p);
        if (L <= 0)
            continue;
        float *s = v + p;
        const int lag = key & 15;
        const bool on = tf > 0.0f;
        const float cs = on ? cosf(half_pi * tf) : 1.0f;
        const float sn = on ? sinf(half_pi * tf) : 0.0f;
        const int sg = lag - 1;
        if (sg >= 2 && ((sigma_mask >> sg) & 1u)) {
            /* stride sigma, coefficients swapped */
            for (int i = 0; i < L - sg; ++i)
                givens(s, i, sg, sn, cs);
            for (int i = L - 2 * sg - 1; i >= 0; --i)
                givens(s, i, sg, sn, cs);
        }
        if (lag > 0 && on) {
            /* lag 1, forward then backward, the running value carried */
            float cur = s[0];
            for (int i = 0; i < L - 1; ++i) {
                const float x2 = s[i + 1];
                s[i] = cs * cur - sn * x2;
                cur = cs * x2 + sn * cur;
            }
            s[L - 1] = cur;
            if (L >= 3) {
                cur = s[L - 2];
                for (int i = L - 3; i >= 0; --i) {
                    const float x1 = s[i];
                    s[i + 1] = cs * cur + sn * x1;
                    cur = cs * x1 - sn * cur;
                }
                s[0] = cur;
            }
        }
        for (int i = 0; i < L; ++i)
            s[i] *= gf;
    }
    __syncwarp();

    /* 4: the row back */
    for (int i = lane; i < W4; i += 32)
        y4[i] = reinterpret_cast<const float4 *>(v)[i];
}

/* Launch on `stream`; returns cudaGetLastError() (0 on success), or
 * cudaErrorInvalidValue for a shape the kernel does not take. x is a
 * device float [R, nmax] plane whose rows lie x_stride floats apart; pk
 * (int32), th and g (float) are contiguous device [R, W]; y is a
 * contiguous device float [R, nmax]. W, nmax and x_stride are multiples
 * of 4 and x, pk and y are 16-byte aligned. sigma_mask has bit s set
 * for each sigma class s in 2..15 that rotates at its stride. */
extern "C" int rotate_plane_launch(
    const float *x, long long x_stride, const int *pk, const float *th,
    const float *g, float *y, int W, int nmax, long long R,
    unsigned sigma_mask, void *stream)
{
    if (W <= 0 || (W & 3) || (nmax & 3) || (x_stride & 3) || W > nmax
        || W > 4096 || x_stride < nmax || R <= 0)
        return (int)cudaErrorInvalidValue;
    /* per warp: W floats, then W 16-bit marker positions, to 16 bytes */
    const int warp_bytes = (6 * W + 15) & ~15;
    const int smem = ROT_WARPS * warp_bytes;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rot_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    const long long blocks = (R + ROT_WARPS - 1) / ROT_WARPS;
    rot_rows_kernel<<<(unsigned)blocks, ROT_WARPS * 32, smem,
                      (cudaStream_t)stream>>>(
        x, x_stride, pk, th, g, y, W, nmax, R, sigma_mask, warp_bytes);
    return (int)cudaGetLastError();
}
