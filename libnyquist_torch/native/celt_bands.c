/* Native CELT band decoding: the host hot path of Opus decode.
 *
 * C translation of OUR Python implementation in formats/opus/celt.py
 * (quant_all_bands + range decoder + PVQ/CWRS + theta splits), which is
 * itself validated bit-exactly against reference goldens. The Python
 * path remains the fallback and the spec; this file exists because the
 * per-symbol entropy loops bound multi-stream host throughput
 * (SURVEY.md §7 "host decode throughput").
 *
 * Float math is double precision in the same operation order as the
 * Python, so outputs agree to ~1e-12.
 */
#include <stdint.h>
#include <string.h>
#include <math.h>

#include "ecdec.h"

/* Optional rdtsc stage profiling (build with -DCELT_PROF; profiling
 * builds only — the shipped .so is compiled without it, so the hot
 * loops carry no counters).  Slots: 0 hdr+energy, 1 bands total,
 * 2 cwrsi+dec_uint, 3 emit_leaf, 4 post-bands, 5 emit rotation. */
#ifdef CELT_PROF
static uint64_t celt_prof_c[8];
static inline uint64_t prof_now(void) {
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
}
#define PROF_T(v) uint64_t v = prof_now()
#define PROF_ADD(i, v) (celt_prof_c[i] += prof_now() - (v))
void celt_prof_get(uint64_t *out) {
    int i;
    for (i = 0; i < 8; i++) { out[i] = celt_prof_c[i]; celt_prof_c[i] = 0; }
}
#else
#define PROF_T(v)
#define PROF_ADD(i, v)
#endif

/* ----------------------------- CWRS ------------------------------ */

#define UMAX_N 242
#define UMAX_K 242
static uint64_t u_table[UMAX_N][UMAX_K];
/* transpose: u_row[b][a] == u_table[a][b]; cwrsi's descending-k searches
   scan a fixed-b slice, which in u_table is a 1.9 KB-stride column (one
   cache miss per step) but in u_row is contiguous. */
static uint64_t u_row[UMAX_K][UMAX_N];
static int u_table_init = 0;

static void pvq_init(void) {
    int n, k;
    if (u_table_init) return;
    /* U(0,0)=1, U(0,K>0)=0, U(N>0,0)=0;
       U(n,k) = U(n-1,k) + U(n,k-1) + U(n-1,k-1).
       Cells whose true value exceeds u64 wrap harmlessly: codable
       streams never index them (V(N,K) < 2^32 by construction). */
    memset(u_table, 0, sizeof(u_table));
    u_table[0][0] = 1;
    for (n = 1; n < UMAX_N; n++)
        for (k = 1; k < UMAX_K; k++)
            u_table[n][k] = u_table[n - 1][k] + u_table[n][k - 1]
                            + u_table[n - 1][k - 1];
    for (n = 0; n < UMAX_N; n++)
        for (k = 0; k < UMAX_K; k++)
            u_row[k][n] = u_table[n][k];
    u_table_init = 1;
}

static uint64_t pvq_u(int n, int k) {
    int a, b;
    if (n < 0 || k < 0) return 0;
    a = n <= k ? n : k;
    b = n <= k ? k : n;
    if (a == 0) return (b == 0) ? 1 : 0;
    return u_table[a][b];
}

/* pvq_u with a <= b known and a >= 1: contiguous in a for fixed b. */
#define PVQ_U_ROW(b) (u_row[(b)])

static uint64_t pvq_v(int n, int k) { return pvq_u(n, k) + pvq_u(n, k + 1); }

static void cwrsi(int n, int k, uint64_t i, int *y) {
    int idx = 0;
    while (n > 2) {
        uint64_t p, q;
        int s, k0, val;
        if (k >= n) {
            p = u_table[n][k + 1];
            s = i >= p;
            if (s) i -= p;
            k0 = k;
            q = u_table[n][n];
            if (q > i) {
                /* k descends below n: fixed-b slice, contiguous scan */
                const uint64_t *row = PVQ_U_ROW(n);
                k = n;
                do {
                    k--;
                    p = (k == 0) ? 0 : row[k];
                } while (p > i);
            }
            else {
                /* k >= n here: u_table[n][k] walks a row (contiguous);
                   pvq_u handles a possible descent below n correctly */
                p = pvq_u(n, k);
                while (p > i) {
                    k--;
                    p = pvq_u(n, k);
                }
            }
            i -= p;
            val = k0 - k;
            y[idx++] = s ? -val : val;
        }
        else {
            /* k < n fixed while n decrements: walk rows k and k+1 of
               u_table backward without the min/max branches of pvq_u */
            p = u_table[k][n];
            q = u_table[k + 1][n];
            if (p <= i && i < q) {
                i -= p;
                y[idx++] = 0;
            }
            else {
                int s2 = i >= q;
                const uint64_t *row = PVQ_U_ROW(n);
                if (s2) i -= q;
                k0 = k;
                do {
                    k--;
                    p = (k == 0) ? 0 : row[k];
                } while (p > i);
                i -= p;
                val = k0 - k;
                y[idx++] = s2 ? -val : val;
            }
        }
        n--;
    }
    /* n == 2 */
    {
        uint64_t p = 2 * (uint64_t)k + 1;
        int s = i >= p;
        int k0, val;
        if (s) i -= p;
        k0 = k;
        k = (int)((i + 1) >> 1);
        if (k) i -= 2 * (uint64_t)k - 1;
        val = k0 - k;
        y[idx++] = s ? -val : val;
    }
    /* n == 1 */
    y[idx++] = (i > 0) ? -k : k;
}

/* --------------------------- helpers ----------------------------- */

#define SPREAD_NONE 0
#define SPREAD_AGGRESSIVE 3
#define QTHETA_OFFSET 4
#define QTHETA_OFFSET_TWOPHASE 16
#define LOG_MAX_PSEUDO 6
#define EPSILON 1e-15

static const int SPREAD_FACTOR[3] = {15, 10, 5};
static const int BIT_ILV[16] = {0,1,1,1,2,3,3,3,2,3,3,3,2,3,3,3};
static const int BIT_DILV[16] = {0x00,0x03,0x0C,0x0F,0x30,0x33,0x3C,0x3F,
                                 0xC0,0xC3,0xCC,0xCF,0xF0,0xF3,0xFC,0xFF};
static const int ORDERY2[2] = {1,0};
static const int ORDERY4[4] = {3,0,2,1};
static const int ORDERY8[8] = {7,0,4,3,6,1,5,2};
static const int ORDERY16[16] = {15,0,8,7,12,3,11,4,14,1,9,6,13,2,10,5};

static const int *ordery(int stride) {
    switch (stride) {
    case 2: return ORDERY2;
    case 4: return ORDERY4;
    case 8: return ORDERY8;
    default: return ORDERY16;
    }
}

static int cdiv(int64_t a, int64_t b) {
    /* C truncating division (Python port uses cdiv everywhere) */
    return (int)(a / b);
}

static int frac_mul16(int a, int b) {
    return (int)((16384 + (int64_t)(int16_t)a * (int16_t)b) >> 15);
}

static int bitexact_cos(int x) {
    int tmp = (4096 + x * x) >> 13;
    int x2 = tmp;
    x2 = (32767 - x2) + frac_mul16(
        x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)));
    return 1 + x2;
}

static int bitexact_log2tan(int isin, int icos) {
    int lc = ec_ilog(icos);
    int ls = ec_ilog(isin);
    icos <<= 15 - lc;
    isin <<= 15 - ls;
    return (ls - lc) * (1 << 11)
        + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
        - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

static uint32_t lcg_rand(uint32_t seed) {
    return 1664525u * seed + 1013904223u;
}

/* ------------------------- trace context -------------------------- */

/* iy-split trace (DESIGN_iy_split.md): when attached to the band
 * context, the float value plane of the PVQ decode is SKIPPED and an
 * integer trace is emitted instead; the device (or the NumPy validator)
 * replays the floats from the trace.  Bit decisions never depend on
 * computed sample values (design fact 1), so the entropy stream is
 * unchanged.  Leaf types: 0 = PVQ vector, 1 = fold fill (reads the
 * transformed lowband), 2 = noise fill (no lowband), 4 = N==1 sign
 * (value +-1, gain ignored — bands.c quant_band_n1).  Zero fills emit
 * nothing (replay buffers default to zero). */
#define LF_PVQ 0
#define LF_FOLD 1
#define LF_NOISE 2
#define LF_N1 4
#define LF_PVQ_IDX 5    /* idx_mode long-frame PVQ: lf_seed holds the
                           PVQ codeword index; cwrsi runs on DEVICE
                           (ops/celt_replay.py pvq kernel).  Valid only
                           where the collapse mask cannot influence
                           decode control flow (B <= 1: bands.c
                           extract_collapse_mask returns 1). */

typedef struct {
    /* leaf stream (parallel arrays, cursor lf_n) */
    int64_t lf_cap, lf_n;
    int32_t *lf_frame;
    int8_t *lf_band, *lf_call, *lf_type;
    int16_t *lf_off, *lf_len;
    int32_t *lf_k;
    int16_t *lf_stride;
    double *lf_gain;
    uint32_t *lf_seed;
    int64_t *lf_iy_off;
    /* PVQ integer vector heap */
    int64_t iy_cap, iy_n;
    int16_t *iy_heap;
    /* dense per (frame, band) records [n_frames * nbEBands] */
    uint8_t *bd_mode;       /* 0 skip, 1 mono, 2 stereo, 3 stereoN2,
                               4 dual, 5 stereoN1 */
    int32_t *bd_eff_lb;     /* lowband offset into norm, -1 = none */
    int8_t *bd_tf;          /* tf_change */
    int16_t *bd_imid, *bd_iside, *bd_itheta;
    int8_t *bd_inv, *bd_sign, *bd_cflag;
    /* anti-collapse records (cursor ac_n) */
    int64_t ac_cap, ac_n;
    int32_t *ac_frame;
    int8_t *ac_band, *ac_c, *ac_k;
    uint32_t *ac_seed;
    float *ac_r;
    /* dense scaled-unrotated PVQ plane [n_frames, 2, xs_nmax] float32:
       g*iy at final positions (g = gain/sqrt(Ryy)) and the +-1 N1
       signs; the device applies the spreading rotations, fills, merges
       and denormalise.  The per-leaf scale is trivial float work the
       host keeps (one sqrt per leaf); the per-sample float plane it
       replaces is what the iy-split moves off-host. */
    float *xs;
    int32_t xs_nmax;
    int32_t raw_iy;         /* 1: store raw iy ints in xs (no host
                               rotation/scale) and the final per-leaf
                               gain g = gain/sqrt(Ryy) in lf_gain; the
                               device rotation pre-pass consumes the
                               trace's (len,k,stride,spread) markers */
    int32_t xs_heap;        /* 1 (raw_iy only): skip the dense xs plane
                               entirely — iy ints (and N1 signs) go to
                               the compact int16 heap in emission order
                               and the device scatters the plane
                               (celt_replay heap pre-pass).  Removes
                               the host's largest remaining memory
                               plane (write-allocate misses on an
                               [F,2,nmax] f32 dense buffer). */
    int32_t idx_mode;       /* 1 (xs_heap only): long frames (B==1)
                               skip host cwrsi entirely — PVQ leaves
                               are emitted as LF_PVQ_IDX carrying the
                               codeword index in lf_seed and the
                               pre-normalisation gain in lf_gain; the
                               device expands index -> iy and computes
                               g = gain/sqrt(Ryy).  Transient frames
                               keep the host path (their collapse
                               masks feed fill/anti-collapse control
                               flow and the rng advance). */
    int32_t *rot_leaf;      /* marker -> emitting leaf index (lf_n at
                               emission) when that leaf is LF_PVQ_IDX
                               (rot_g then holds the PRE gain and the
                               device multiplies by rsqrt(Ryy)); -1
                               for markers whose rot_g is final. */
    /* rotation sub-segment markers (raw_iy traces): emitted here so
       the Python assembly (celt_replay._rotation_markers, the spec
       and fallback for this plane) is off the serving hot path.
       One marker per exp_rotation sub-segment, plus one identity
       marker per non-rotating leaf; rot_pk = col<<13|len<<4|lag. */
    int32_t *rot_row, *rot_col, *rot_pk;
    float *rot_th, *rot_g;
    int64_t rot_cap, rot_n;
    uint32_t rot_sigmas;    /* bitmask of emitted sigma2 values */
    int32_t cur_bandoff;    /* M * eBands[current band] */
    int err;                /* set on capacity overflow */
} tracectx;

/* ------------------------- band context -------------------------- */

typedef struct {
    const int16_t *eBands;
    const int16_t *logN;
    const int16_t *cache_index;
    const uint8_t *cache_bits;
    int nbEBands;
    int band;
    int intensity;
    int spread;
    int tf_change;
    ecdec *dec;
    int64_t remaining_bits;
    uint32_t seed;
    /* iy-split trace state (NULL tr = normal full-float decode) */
    tracectx *tr;
    int64_t cur_frame;
    int cur_call;               /* 0 = X/mono/dual-L, 1 = Y/dual-R */
    const double *band_base;    /* leaf offsets = X - band_base */
} bctx;

static void exp_rotation(double *X, int len, int dir, int stride, int K,
                         int spread);

static void emit_rot_plain(tracectx *T, int rowi, int col, int N,
                           float g, int32_t leaf) {
    int64_t rn = T->rot_n;
    int ln = N > 0 ? N : 1;
    if (rn >= T->rot_cap) { T->err = 1; return; }
    T->rot_row[rn] = rowi;
    T->rot_col[rn] = col;
    T->rot_pk[rn] = (col << 13) | (ln << 4) | 1;
    T->rot_th[rn] = 0.f;
    T->rot_g[rn] = g;
    if (T->rot_leaf) T->rot_leaf[rn] = leaf;
    T->rot_n = rn + 1;
}

/* Rotation markers for one leaf (bit-identical to the Python spec
   celt_replay._rotation_markers, which remains the fallback/oracle):
   non-rotating leaves get one identity marker; rotating PVQ leaves get
   one marker per exp_rotation sub-segment (vq.c:78 splits the leaf
   into `stride` sub-segments of len/stride, remainder untouched). */
static void emit_rot_markers(bctx *ctx, tracectx *T, int type,
                             const double *X, int N, int K, int stride,
                             double g) {
    int rowi = (int)(ctx->cur_frame * 2 + ctx->cur_call);
    int col = T->cur_bandoff + (int)(X - ctx->band_base);
    /* LF_PVQ_IDX markers carry the PRE gain; the device multiplies by
       rsqrt(Ryy) of this leaf after its cwrsi pass */
    int32_t leaf = type == LF_PVQ_IDX ? (int32_t)T->lf_n : -1;
    if ((type == LF_PVQ || type == LF_PVQ_IDX)
        && 2 * K < N && ctx->spread != SPREAD_NONE
        && N >= (stride > 1 ? stride : 1)) {
        int s2 = 0, Lsub, rem, nsub, jj;
        double gr = (double)N
            / (double)(N + SPREAD_FACTOR[ctx->spread - 1] * K);
        float th = (float)(0.5 * gr * gr);
        if (N >= 8 * stride) {
            s2 = 1;
            while ((s2 * s2 + s2) * stride + (stride >> 2) < N) s2++;
        }
        Lsub = N / stride;
        rem = N % stride;
        nsub = stride + (rem > 0);
        if (T->rot_n + nsub > T->rot_cap) { T->err = 1; return; }
        for (jj = 0; jj < nsub; jj++) {
            int tail = jj >= stride;
            int scol = col + jj * Lsub;
            int slen = tail ? rem : Lsub;
            int lagv = tail ? 1 : 1 + s2;
            int64_t rn = T->rot_n;
            if (slen < 1) slen = 1;
            T->rot_row[rn] = rowi;
            T->rot_col[rn] = scol;
            T->rot_pk[rn] = (scol << 13) | (slen << 4) | lagv;
            T->rot_th[rn] = tail ? 0.f : th;
            T->rot_g[rn] = (float)g;
            if (T->rot_leaf) T->rot_leaf[rn] = leaf;
            T->rot_n = rn + 1;
        }
        if (s2 > 0) T->rot_sigmas |= 1u << s2;
    } else {
        emit_rot_plain(T, rowi, col, N,
                       (type == LF_PVQ || type == LF_PVQ_IDX)
                           ? (float)g : 1.f,
                       leaf);
    }
}

static void emit_leaf(bctx *ctx, int type, const double *X, int N, int K,
                      int stride, double gain, uint32_t seed,
                      const int *iy) {
    tracectx *T = ctx->tr;
    PROF_T(pe0);
    int64_t n = T->lf_n;
    if (n >= T->lf_cap) { T->err = 1; return; }
    T->lf_frame[n] = (int32_t)ctx->cur_frame;
    T->lf_band[n] = (int8_t)ctx->band;
    T->lf_call[n] = (int8_t)ctx->cur_call;
    T->lf_type[n] = (int8_t)type;
    T->lf_off[n] = (int16_t)(X - ctx->band_base);
    T->lf_len[n] = (int16_t)N;
    T->lf_k[n] = K;
    T->lf_stride[n] = (int16_t)stride;
    T->lf_gain[n] = gain;
    T->lf_seed[n] = seed;
    if (type == LF_PVQ_IDX) {
        /* device-cwrsi leaf: lf_seed already holds the codeword index
           (seed arg), lf_gain the PRE gain; values never touch the
           host.  Markers carry the pre gain + this leaf's id. */
        T->lf_iy_off[n] = -1;
        if (T->rot_row)
            emit_rot_markers(ctx, T, type, X, N, K, stride, gain);
    } else if (type == LF_PVQ) {
        int j;
        int64_t Ryy = 0;
        double g;
        float *xs;
        if (T->iy_heap) {
            /* heap emission: the raw integer vectors, in decode order
               (validation replayer input; in xs_heap mode also the
               production value plane — device scatter rebuilds the
               dense layout from lf_iy_off deltas) */
            if (T->iy_n + N > T->iy_cap) { T->err = 1; return; }
            T->lf_iy_off[n] = T->iy_n;
            for (j = 0; j < N; j++)
                T->iy_heap[T->iy_n + j] = (int16_t)iy[j];
            T->iy_n += N;
        } else {
            T->lf_iy_off[n] = -1;
        }
        for (j = 0; j < N; j++) Ryy += (int64_t)iy[j] * iy[j];
        g = gain / sqrt((double)Ryy);
        if (T->raw_iy) {
            /* iy-split v2: raw integer plane; the device applies
               g and the spreading rotation (segmented affine scans,
               ops/celt_replay.py rotate_plane). */
            T->lf_gain[n] = g;
            if (!T->xs_heap) {
                xs = T->xs + ((ctx->cur_frame * 2 + ctx->cur_call)
                              * (int64_t)T->xs_nmax)
                    + T->cur_bandoff + (X - ctx->band_base);
                for (j = 0; j < N; j++) xs[j] = (float)iy[j];
            }
            if (T->rot_row)
                emit_rot_markers(ctx, T, type, X, N, K, stride, g);
        } else {
            xs = T->xs + ((ctx->cur_frame * 2 + ctx->cur_call)
                          * (int64_t)T->xs_nmax)
                + T->cur_bandoff + (X - ctx->band_base);
            /* spreading rotation applied HERE, in the same double
               precision as the full-float decode (vq.c alg_unquant
               order: normalise then exp_rotation), so the device
               replay consumes finished leaf values.  Measured: the
               rotation as device gather+matmul+scatter buckets cost
               1.59s/stream on TPU (scatter-bound); as host scalar
               code it is ~190 Mcy (~0.07s) -- see DESIGN_iy_split.md. */
            double seg[256];
            PROF_T(pr0);
            for (j = 0; j < N; j++) seg[j] = g * iy[j];
            exp_rotation(seg, N, -1, stride, K, ctx->spread);
            for (j = 0; j < N; j++) xs[j] = (float)seg[j];
            PROF_ADD(5, pr0);
        }
    } else {
        T->lf_iy_off[n] = -1;
        if (type == LF_N1) {
            if (T->xs_heap) {
                /* single-sign leaves ride the heap too (len-1 entry) */
                if (T->iy_n + 1 > T->iy_cap) { T->err = 1; return; }
                T->lf_iy_off[n] = T->iy_n;
                T->iy_heap[T->iy_n++] = (int16_t)K;
            } else {
                T->xs[(ctx->cur_frame * 2 + ctx->cur_call)
                      * (int64_t)T->xs_nmax + T->cur_bandoff] = (float)K;
            }
        }
        if (T->rot_row)
            emit_rot_markers(ctx, T, type, X, N, K, stride, 1.0);
    }
    T->lf_n = n + 1;
    PROF_ADD(3, pe0);
}

static void exp_rotation1(double *X, int len, int stride, double c, double s) {
    int i;
    for (i = 0; i < len - stride; i++) {
        double x1 = X[i], x2 = X[i + stride];
        X[i + stride] = c * x2 + s * x1;
        X[i] = c * x1 - s * x2;
    }
    for (i = len - 2 * stride - 1; i >= 0; i--) {
        double x1 = X[i], x2 = X[i + stride];
        X[i + stride] = c * x2 + s * x1;
        X[i] = c * x1 - s * x2;
    }
}

static void exp_rotation(double *X, int len, int dir, int stride, int K,
                         int spread) {
    double factor, gain, theta, c, s;
    int stride2 = 0, i;
    if (2 * K >= len || spread == SPREAD_NONE) return;
    factor = SPREAD_FACTOR[spread - 1];
    gain = 1.0 * len / (len + factor * K);
    theta = 0.5 * gain * gain;
    c = cos(0.5 * M_PI * theta);
    s = cos(0.5 * M_PI * (1.0 - theta));
    if (len >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len)
            stride2++;
    }
    len /= stride;
    for (i = 0; i < stride; i++) {
        double *seg = X + i * len;
        if (dir < 0) {
            if (stride2) exp_rotation1(seg, len, stride2, s, c);
            exp_rotation1(seg, len, 1, c, s);
        }
        else {
            exp_rotation1(seg, len, 1, c, -s);
            if (stride2) exp_rotation1(seg, len, stride2, s, -c);
        }
    }
}

static int extract_collapse_mask(const int *iy, int N, int B) {
    int N0, mask = 0, i, j;
    if (B <= 1) return 1;
    N0 = N / B;
    for (i = 0; i < B; i++) {
        int sub = 0;
        for (j = 0; j < N0; j++) sub |= iy[i * N0 + j];
        mask |= (sub != 0) << i;
    }
    return mask;
}

static int alg_unquant_tr(bctx *ctx, double *X, int N, int K, int spread,
                          int B, ecdec *dec, double gain) {
    int iy[256];
    double Ryy = 0, g;
    uint32_t idx;
    int j;
    PROF_T(pc0);
    idx = ec_dec_uint(dec, (uint32_t)pvq_v(N, K));
    if (ctx && ctx->tr && ctx->tr->idx_mode && B <= 1) {
        /* long frame: collapse mask is identically 1 (B <= 1), so the
           values cannot influence decode control flow — hand the
           index straight to the device cwrsi kernel. */
        PROF_ADD(2, pc0);
        emit_leaf(ctx, LF_PVQ_IDX, X, N, K, B, gain, idx, 0);
        return 1;
    }
    cwrsi(N, K, idx, iy);
    PROF_ADD(2, pc0);
    if (ctx && ctx->tr) {
        emit_leaf(ctx, LF_PVQ, X, N, K, B, gain, 0, iy);
        return extract_collapse_mask(iy, N, B);
    }
    for (j = 0; j < N; j++) Ryy += (double)iy[j] * iy[j];
    g = gain / sqrt(Ryy);
    for (j = 0; j < N; j++) X[j] = g * iy[j];
    exp_rotation(X, N, -1, B, K, spread);
    return extract_collapse_mask(iy, N, B);
}

static int alg_unquant(double *X, int N, int K, int spread, int B, ecdec *dec,
                       double gain) {
    return alg_unquant_tr(0, X, N, K, spread, B, dec, gain);
}

static void renormalise_vector(double *X, int N, double gain) {
    double E = EPSILON;
    int j;
    for (j = 0; j < N; j++) E += X[j] * X[j];
    {
        double g = gain / sqrt(E);
        for (j = 0; j < N; j++) X[j] *= g;
    }
}

static void haar1(double *X, int n0, int stride) {
    int i, j;
    double s = sqrt(0.5);
    n0 >>= 1;
    for (i = 0; i < stride; i++)
        for (j = 0; j < n0; j++) {
            int a = stride * 2 * j + i;
            int b = stride * (2 * j + 1) + i;
            double t1 = s * X[a], t2 = s * X[b];
            X[a] = t1 + t2;
            X[b] = t1 - t2;
        }
}

static void deinterleave_hadamard(double *X, int N0, int stride, int had) {
    double tmp[1024];
    int N = N0 * stride, i, j;
    if (had) {
        const int *ord = ordery(stride);
        for (i = 0; i < stride; i++)
            for (j = 0; j < N0; j++)
                tmp[ord[i] * N0 + j] = X[j * stride + i];
    }
    else {
        for (i = 0; i < stride; i++)
            for (j = 0; j < N0; j++)
                tmp[i * N0 + j] = X[j * stride + i];
    }
    memcpy(X, tmp, N * sizeof(double));
}

static void interleave_hadamard(double *X, int N0, int stride, int had) {
    double tmp[1024];
    int N = N0 * stride, i, j;
    if (had) {
        const int *ord = ordery(stride);
        for (i = 0; i < stride; i++)
            for (j = 0; j < N0; j++)
                tmp[j * stride + i] = X[ord[i] * N0 + j];
    }
    else {
        for (i = 0; i < stride; i++)
            for (j = 0; j < N0; j++)
                tmp[j * stride + i] = X[i * N0 + j];
    }
    memcpy(X, tmp, N * sizeof(double));
}


static const uint8_t *band_cache(const bctx *c, int band, int LM) {
    return c->cache_bits + c->cache_index[(LM + 1) * c->nbEBands + band];
}

static int get_pulses(int i) {
    return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

static int bits2pulses(const bctx *c, int band, int LM, int bits) {
    const uint8_t *cache = band_cache(c, band, LM);
    int lo = 0, hi = cache[0], it;
    bits--;
    for (it = 0; it < LOG_MAX_PSEUDO; it++) {
        int mid = (lo + hi + 1) >> 1;
        if ((int)cache[mid] >= bits) hi = mid;
        else lo = mid;
    }
    if (bits - (lo == 0 ? -1 : (int)cache[lo]) <= (int)cache[hi] - bits)
        return lo;
    return hi;
}

static int pulses2bits(const bctx *c, int band, int LM, int pulses) {
    const uint8_t *cache = band_cache(c, band, LM);
    return pulses == 0 ? 0 : (int)cache[pulses] + 1;
}

static int compute_qn(int N, int b, int offset, int pulse_cap, int stereo) {
    static const int exp2t[8] = {16384, 17866, 19483, 21247, 23170, 25267,
                                 27554, 30048};
    int N2 = 2 * N - 1, qb, qn;
    if (stereo && N == 2) N2--;
    qb = cdiv((int64_t)b + (int64_t)N2 * offset, N2);
    if (b - pulse_cap - (4 << BITRES) < qb) qb = b - pulse_cap - (4 << BITRES);
    if (qb > (8 << BITRES)) qb = 8 << BITRES;
    if (qb < (1 << BITRES >> 1)) qn = 1;
    else {
        qn = exp2t[qb & 0x7] >> (14 - (qb >> BITRES));
        qn = ((qn + 1) >> 1) << 1;
    }
    return qn;
}

typedef struct {
    int inv, imid, iside, delta, itheta;
    int64_t qalloc;
} splitctx;

static int isqrt64(uint64_t v) {
    uint64_t r = (uint64_t)sqrt((double)v);
    while (r * r > v) r--;
    while ((r + 1) * (r + 1) <= v) r++;
    return (int)r;
}

static void compute_theta(bctx *ctx, splitctx *sctx, int N, int *b, int B,
                          int B0, int LM, int stereo, int *fill) {
    ecdec *dec = ctx->dec;
    int i = ctx->band;
    int pulse_cap = ctx->logN[i] + LM * (1 << BITRES);
    int offset = (pulse_cap >> 1)
        - ((stereo && N == 2) ? QTHETA_OFFSET_TWOPHASE : QTHETA_OFFSET);
    int qn = compute_qn(N, *b, offset, pulse_cap, stereo);
    int itheta = 0, inv = 0;
    int imid, iside, delta;
    int64_t tell;
    if (stereo && i >= ctx->intensity) qn = 1;
    tell = ec_tell_frac(dec);
    if (qn != 1) {
        if (stereo && N > 2) {
            int p0 = 3, x0 = qn / 2;
            uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
            uint32_t fs = ec_decode(dec, ft);
            int x;
            if (fs < (uint32_t)((x0 + 1) * p0)) x = fs / p0;
            else x = x0 + 1 + (fs - (x0 + 1) * p0);
            ec_update(dec,
                      x <= x0 ? p0 * x : (x - 1 - x0) + (x0 + 1) * p0,
                      x <= x0 ? p0 * (x + 1) : (x - x0) + (x0 + 1) * p0,
                      ft);
            itheta = x;
        }
        else if (B0 > 1 || stereo) {
            itheta = (int)ec_dec_uint(dec, qn + 1);
        }
        else {
            uint32_t ft = (uint32_t)(((qn >> 1) + 1) * ((qn >> 1) + 1));
            uint32_t fm = ec_decode(dec, ft);
            uint32_t fl, fs;
            if (fm < (uint32_t)((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
                itheta = (isqrt64(8 * (uint64_t)fm + 1) - 1) >> 1;
                fs = itheta + 1;
                fl = (uint32_t)(itheta * (itheta + 1) >> 1);
            }
            else {
                itheta = (2 * (qn + 1)
                          - isqrt64(8 * (uint64_t)(ft - fm - 1) + 1)) >> 1;
                fs = qn + 1 - itheta;
                fl = ft - (uint32_t)((qn + 1 - itheta) * (qn + 2 - itheta)
                                     >> 1);
            }
            ec_update(dec, fl, fl + fs, ft);
        }
        itheta = (int)(((int64_t)itheta * 16384) / qn);
    }
    else if (stereo) {
        if (*b > 2 << BITRES && ctx->remaining_bits > 2 << BITRES)
            inv = ec_dec_bit_logp(dec, 2);
        itheta = 0;
    }
    sctx->qalloc = ec_tell_frac(dec) - tell;
    *b -= (int)sctx->qalloc;

    if (itheta == 0) {
        imid = 32767;
        iside = 0;
        *fill &= (1 << B) - 1;
        delta = -16384;
    }
    else if (itheta == 16384) {
        imid = 0;
        iside = 32767;
        *fill &= ((1 << B) - 1) << B;
        delta = 16384;
    }
    else {
        imid = bitexact_cos(itheta);
        iside = bitexact_cos(16384 - itheta);
        delta = frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid));
    }
    sctx->inv = inv;
    sctx->imid = imid;
    sctx->iside = iside;
    sctx->delta = delta;
    sctx->itheta = itheta;
}

static int quant_band(bctx *ctx, double *X, int N, int b, int B,
                      double *lowband, int LM, double *lowband_out,
                      double gain, double *lowband_scratch, int fill);

static int quant_band_n1(bctx *ctx, double *X, double *Y, int b,
                         double *lowband_out) {
    ecdec *dec = ctx->dec;
    double *chans[2];
    int nch = Y ? 2 : 1, c;
    chans[0] = X;
    chans[1] = Y;
    for (c = 0; c < nch; c++) {
        int sign = 0;
        if (ctx->remaining_bits >= 1 << BITRES) {
            sign = (int)ec_dec_bits(dec, 1);
            ctx->remaining_bits -= 1 << BITRES;
            b -= 1 << BITRES;
        }
        if (ctx->tr) {
            /* value is +-1 regardless of gain (bands.c quant_band_n1);
               stereo N==1 emits one leaf per channel slot.  Offset is
               always 0 within the band (emit via band_base: chans[1]
               points into the other channel's buffer). */
            if (Y) ctx->cur_call = c;
            emit_leaf(ctx, LF_N1, ctx->band_base, 1, sign ? -1 : 1, 1,
                      1.0, 0, 0);
        }
        else
            chans[c][0] = sign ? -1.0 : 1.0;
    }
    if (lowband_out && !ctx->tr) lowband_out[0] = X[0];
    return 1;
}

static int quant_partition(bctx *ctx, double *X, int N, int b, int B,
                           double *lowband, int LM, double gain, int fill) {
    int i = ctx->band;
    ecdec *dec = ctx->dec;
    int B0 = B;
    const uint8_t *cache = band_cache(ctx, i, LM);
    int cm;
    if (LM != -1 && b > (int)cache[cache[0]] + 12 && N > 2) {
        double *Y;
        splitctx sctx;
        int imid, iside, delta, itheta;
        double mid, side;
        int mbits, sbits;
        int64_t rebalance;
        double *next_lowband2 = 0;
        N >>= 1;
        Y = X + N;
        LM -= 1;
        if (B == 1) fill = (fill & 1) | (fill << 1);
        B = (B + 1) >> 1;
        compute_theta(ctx, &sctx, N, &b, B, B0, LM, 0, &fill);
        imid = sctx.imid;
        iside = sctx.iside;
        delta = sctx.delta;
        itheta = sctx.itheta;
        mid = imid / 32768.0;
        side = iside / 32768.0;
        if (B0 > 1 && (itheta & 0x3FFF)) {
            if (itheta > 8192) delta -= delta >> (4 - LM);
            else {
                int t = delta + (N << BITRES >> (5 - LM));
                delta = t < 0 ? t : 0;
            }
        }
        mbits = cdiv(b - delta, 2);
        if (mbits > b) mbits = b;
        if (mbits < 0) mbits = 0;
        sbits = b - mbits;
        ctx->remaining_bits -= sctx.qalloc;
        if (lowband) next_lowband2 = lowband + N;
        rebalance = ctx->remaining_bits;
        if (mbits >= sbits) {
            cm = quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                 gain * mid, fill);
            rebalance = mbits - (rebalance - ctx->remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 0)
                sbits += (int)(rebalance - (3 << BITRES));
            cm |= quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                  gain * side, fill >> B) << (B0 >> 1);
        }
        else {
            cm = quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                 gain * side, fill >> B) << (B0 >> 1);
            rebalance = sbits - (rebalance - ctx->remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 16384)
                mbits += (int)(rebalance - (3 << BITRES));
            cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                  gain * mid, fill);
        }
    }
    else {
        int q = bits2pulses(ctx, i, LM, b);
        int curr_bits = pulses2bits(ctx, i, LM, q);
        ctx->remaining_bits -= curr_bits;
        while (ctx->remaining_bits < 0 && q > 0) {
            ctx->remaining_bits += curr_bits;
            q--;
            curr_bits = pulses2bits(ctx, i, LM, q);
            ctx->remaining_bits -= curr_bits;
        }
        if (q != 0) {
            int K = get_pulses(q);
            cm = alg_unquant_tr(ctx, X, N, K, ctx->spread, B, dec, gain);
        }
        else {
            int cm_mask = (1 << B) - 1;
            fill &= cm_mask;
            if (!fill) {
                if (!ctx->tr) memset(X, 0, N * sizeof(double));
                cm = 0;
            }
            else if (ctx->tr) {
                /* trace mode: record the fill leaf and advance the LCG
                   by exactly the draws the full decode would consume */
                int j;
                emit_leaf(ctx, lowband ? LF_FOLD : LF_NOISE, X, N, 0, B,
                          gain, ctx->seed, 0);
                for (j = 0; j < N; j++) ctx->seed = lcg_rand(ctx->seed);
                cm = lowband ? fill : cm_mask;
            }
            else {
                int j;
                if (!lowband) {
                    for (j = 0; j < N; j++) {
                        ctx->seed = lcg_rand(ctx->seed);
                        X[j] = (double)((int32_t)ctx->seed >> 20);
                    }
                    cm = cm_mask;
                }
                else {
                    for (j = 0; j < N; j++) {
                        double tmp;
                        ctx->seed = lcg_rand(ctx->seed);
                        tmp = (ctx->seed & 0x8000) ? (1.0 / 256) : -(1.0 / 256);
                        X[j] = lowband[j] + tmp;
                    }
                    cm = fill;
                }
                renormalise_vector(X, N, gain);
            }
        }
    }
    return cm;
}

static int quant_band(bctx *ctx, double *X, int N, int b, int B,
                      double *lowband, int LM, double *lowband_out,
                      double gain, double *lowband_scratch, int fill) {
    int N0 = N, N_B = N, N_B0;
    int B0 = B, time_divide = 0, recombine = 0;
    int longBlocks = B0 == 1;
    int tf_change = ctx->tf_change;
    int k, cm;

    N_B /= B;
    if (N == 1)
        return quant_band_n1(ctx, X, 0, b, lowband_out);

    if (tf_change > 0) recombine = tf_change;
    if (lowband_scratch && lowband
        && (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
        /* trace mode keeps the pointer swap (NULLness + offsets) but
           skips the copy: lowband values are replayed on device */
        if (!ctx->tr) memcpy(lowband_scratch, lowband, N * sizeof(double));
        lowband = lowband_scratch;
    }

    for (k = 0; k < recombine; k++) {
        if (lowband && !ctx->tr) haar1(lowband, N >> k, 1 << k);
        fill = BIT_ILV[fill & 0xF] | BIT_ILV[fill >> 4] << 2;
    }
    B >>= recombine;
    N_B <<= recombine;

    while ((N_B & 1) == 0 && tf_change < 0) {
        if (lowband && !ctx->tr) haar1(lowband, N_B, B);
        fill |= fill << B;
        B <<= 1;
        N_B >>= 1;
        time_divide++;
        tf_change++;
    }
    B0 = B;
    N_B0 = N_B;

    if (B0 > 1 && lowband && !ctx->tr)
        deinterleave_hadamard(lowband, N_B >> recombine, B0 << recombine,
                              longBlocks);

    cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill);

    /* resynthesis */
    if (B0 > 1 && !ctx->tr)
        interleave_hadamard(X, N_B >> recombine, B0 << recombine, longBlocks);
    N_B = N_B0;
    B = B0;
    for (k = 0; k < time_divide; k++) {
        B >>= 1;
        N_B <<= 1;
        cm |= cm >> B;
        if (!ctx->tr) haar1(X, N_B, B);
    }
    for (k = 0; k < recombine; k++) {
        cm = BIT_DILV[cm];
        if (!ctx->tr) haar1(X, N0 >> k, 1 << k);
    }
    B <<= recombine;

    if (lowband_out && !ctx->tr) {
        int j;
        double n = sqrt((double)N0);
        for (j = 0; j < N0; j++) lowband_out[j] = n * X[j];
    }
    cm &= (1 << B) - 1;
    return cm;
}

static void stereo_merge(double *X, double *Y, double mid, int N) {
    double xp = 0, side = 0, El, Er, lgain, rgain;
    int j;
    for (j = 0; j < N; j++) {
        xp += Y[j] * X[j];
        side += Y[j] * Y[j];
    }
    xp *= mid;
    El = mid * mid + side - 2 * xp;
    Er = mid * mid + side + 2 * xp;
    if (Er < 6e-4 || El < 6e-4) {
        memcpy(Y, X, N * sizeof(double));
        return;
    }
    lgain = 1.0 / sqrt(El);
    rgain = 1.0 / sqrt(Er);
    for (j = 0; j < N; j++) {
        double l = mid * X[j], r = Y[j];
        X[j] = lgain * (l - r);
        Y[j] = rgain * (l + r);
    }
}

static int quant_band_stereo(bctx *ctx, double *X, double *Y, int N, int b,
                             int B, double *lowband, int LM,
                             double *lowband_out, double *lowband_scratch,
                             int fill) {
    ecdec *dec = ctx->dec;
    splitctx sctx;
    int imid, iside, itheta, inv;
    double mid, side;
    int cm;
    int orig_fill = fill;
    tracectx *T = ctx->tr;
    int64_t bslot = T ? ctx->cur_frame * ctx->nbEBands + ctx->band : 0;
    if (N == 1) {
        if (T) T->bd_mode[bslot] = 5;
        return quant_band_n1(ctx, X, Y, b, lowband_out);
    }
    compute_theta(ctx, &sctx, N, &b, B, B, LM, 1, &fill);
    inv = sctx.inv;
    imid = sctx.imid;
    iside = sctx.iside;
    itheta = sctx.itheta;
    mid = imid / 32768.0;
    side = iside / 32768.0;
    if (T) {
        T->bd_imid[bslot] = (int16_t)imid;
        T->bd_iside[bslot] = (int16_t)iside;
        T->bd_itheta[bslot] = (int16_t)itheta;
        T->bd_inv[bslot] = (int8_t)inv;
    }

    if (N == 2) {
        int mbits = b, sbits = 0, c, sign = 0;
        double *x2, *y2, tmp;
        if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
        mbits -= sbits;
        c = itheta > 8192;
        ctx->remaining_bits -= sctx.qalloc + sbits;
        x2 = c ? Y : X;
        y2 = c ? X : Y;
        if (sbits) sign = (int)ec_dec_bits(dec, 1);
        sign = 1 - 2 * sign;
        if (T) {
            T->bd_mode[bslot] = 3;
            T->bd_sign[bslot] = (int8_t)sign;
            T->bd_cflag[bslot] = (int8_t)c;
            ctx->cur_call = c;
            /* leaves of the decoded x2 live at offset 0 of whichever
               slot c selects; replay reads them from slot c */
            ctx->band_base = x2;
        }
        cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out, 1.0,
                        lowband_scratch, orig_fill);
        if (!T) {
            y2[0] = -sign * x2[1];
            y2[1] = sign * x2[0];
            X[0] *= mid;
            X[1] *= mid;
            Y[0] *= side;
            Y[1] *= side;
            tmp = X[0];
            X[0] = tmp - Y[0];
            Y[0] = tmp + Y[0];
            tmp = X[1];
            X[1] = tmp - Y[1];
            Y[1] = tmp + Y[1];
        }
    }
    else {
        int mbits = cdiv(b - sctx.delta, 2), sbits;
        int64_t rebalance;
        if (mbits > b) mbits = b;
        if (mbits < 0) mbits = 0;
        sbits = b - mbits;
        ctx->remaining_bits -= sctx.qalloc;
        rebalance = ctx->remaining_bits;
        if (T) T->bd_mode[bslot] = 2;
        if (mbits >= sbits) {
            if (T) { ctx->cur_call = 0; ctx->band_base = X; }
            cm = quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                            1.0, lowband_scratch, fill);
            rebalance = mbits - (rebalance - ctx->remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 0)
                sbits += (int)(rebalance - (3 << BITRES));
            if (T) { ctx->cur_call = 1; ctx->band_base = Y; }
            cm |= quant_band(ctx, Y, N, sbits, B, 0, LM, 0, side, 0,
                             fill >> B);
        }
        else {
            if (T) { ctx->cur_call = 1; ctx->band_base = Y; }
            cm = quant_band(ctx, Y, N, sbits, B, 0, LM, 0, side, 0,
                            fill >> B);
            rebalance = sbits - (rebalance - ctx->remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 16384)
                mbits += (int)(rebalance - (3 << BITRES));
            if (T) { ctx->cur_call = 0; ctx->band_base = X; }
            cm |= quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                             1.0, lowband_scratch, fill);
        }
    }
    if (N != 2 && !T)
        stereo_merge(X, Y, mid, N);
    if (inv && !T) {
        int j;
        for (j = 0; j < N; j++) Y[j] = -Y[j];
    }
    return cm;
}

/* --------------------------- entry point -------------------------- */

/* ec state layout (int64 x10): offs, end_offs, end_window, nend_bits,
   nbits_total, rng, rem, val, ext, error */
static uint32_t celt_bands_decode_i(
    const uint8_t *buf, uint32_t storage, int64_t *ec,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const int16_t *cache_index, const uint8_t *cache_bits,
    int start, int end, int shortBlocks, int spread, int dual_stereo,
    int intensity, const int32_t *tf_res, int64_t total_bits,
    int64_t balance, const int32_t *pulses, int LM, int codedBands,
    uint32_t seed, int C, double *X_, uint8_t *collapse_masks,
    tracectx *T, int64_t frame_idx, int32_t *avg_band_out)
{
    ecdec dec;
    bctx ctx;
    int M = 1 << LM;
    int B = shortBlocks ? shortBlocks : 1;
    int norm_offset = M * eBands[start];
    int norm_len = M * eBands[nbEBands - 1] - norm_offset;
    double norm_buf[2 * 1696];
    double scratch[1920];
    double *norm = norm_buf;
    double *norm2 = (C == 2) ? norm_buf + norm_len : norm_buf;
    int lowband_offset = 0;
    int update_lowband = 1;
    int i;
    int N_full = M * eBands[nbEBands];

    pvq_init();
    memset(norm_buf, 0, sizeof(norm_buf));

    dec.buf = buf;
    dec.storage = storage;
    dec.offs = (uint32_t)ec[0];
    dec.end_offs = (uint32_t)ec[1];
    dec.end_window = (uint64_t)ec[2];
    dec.nend_bits = (int)ec[3];
    dec.nbits_total = (int)ec[4];
    dec.rng = (uint32_t)ec[5];
    dec.rem = (int)ec[6];
    dec.val = (uint32_t)ec[7];
    dec.ext = (uint32_t)ec[8];
    dec.error = (int)ec[9];

    ctx.eBands = eBands;
    ctx.logN = logN;
    ctx.cache_index = cache_index;
    ctx.cache_bits = cache_bits;
    ctx.nbEBands = nbEBands;
    ctx.intensity = intensity;
    ctx.spread = spread;
    ctx.dec = &dec;
    ctx.seed = seed;
    ctx.tr = T;
    ctx.cur_frame = frame_idx;
    ctx.cur_call = 0;
    ctx.band_base = 0;

    for (i = start; i < end; i++) {
        int last = (i == end - 1);
        double *X = X_ + M * eBands[i];
        double *Y = (C == 2) ? X_ + N_full + M * eBands[i] : 0;
        int N = M * eBands[i + 1] - M * eBands[i];
        int64_t tell = ec_tell_frac(&dec);
        int b, tf_change, x_cm, y_cm;
        int effective_lowband = -1;
        double *lowband_scratch;

        ctx.band = i;
        if (i != start) balance -= tell;
        ctx.remaining_bits = total_bits - tell - 1;
        if (i <= codedBands - 1) {
            int cb = codedBands - i;
            int64_t curr_balance;
            if (cb > 3) cb = 3;
            curr_balance = balance / cb;  /* cdiv semantics: both >= 0 or
                                             C-truncation; balance may be
                                             negative -> truncate */
            if (balance < 0) curr_balance = -((-balance) / cb);
            {
                int64_t bb = pulses[i] + curr_balance;
                if (bb > ctx.remaining_bits + 1) bb = ctx.remaining_bits + 1;
                if (bb > 16383) bb = 16383;
                if (bb < 0) bb = 0;
                b = (int)bb;
            }
        }
        else b = 0;

        if (M * eBands[i] - N >= M * eBands[start]
            && (update_lowband || lowband_offset == 0))
            lowband_offset = i;

        tf_change = tf_res[i];
        ctx.tf_change = tf_change;
        lowband_scratch = scratch;
        if (i == end - 1) lowband_scratch = 0;

        if (lowband_offset != 0
            && (spread != SPREAD_AGGRESSIVE || B > 1 || tf_change < 0)) {
            int fold_start, fold_end, fold_i;
            effective_lowband = M * eBands[lowband_offset] - norm_offset - N;
            if (effective_lowband < 0) effective_lowband = 0;
            fold_start = lowband_offset;
            while (M * eBands[fold_start - 1]
                   > effective_lowband + norm_offset)
                fold_start--;
            fold_start--;
            fold_end = lowband_offset - 1;
            do {
                fold_end++;
            } while (M * eBands[fold_end]
                     < effective_lowband + norm_offset + N);
            x_cm = y_cm = 0;
            for (fold_i = fold_start; fold_i < fold_end; fold_i++) {
                x_cm |= collapse_masks[fold_i * C + 0];
                y_cm |= collapse_masks[fold_i * C + C - 1];
            }
        }
        else
            x_cm = y_cm = (1 << B) - 1;

        if (dual_stereo && i == intensity) {
            int j;
            dual_stereo = 0;
            if (T) {
                if (avg_band_out) *avg_band_out = i;
            }
            else
                for (j = 0; j < M * eBands[i] - norm_offset; j++)
                    norm[j] = 0.5 * (norm[j] + norm2[j]);
        }

        if (T) {
            int64_t bslot = frame_idx * nbEBands + i;
            T->bd_eff_lb[bslot] = effective_lowband;
            T->bd_tf[bslot] = (int8_t)tf_change;
            T->cur_bandoff = M * eBands[i];
        }

        if (dual_stereo) {
            if (T) {
                T->bd_mode[frame_idx * nbEBands + i] = 4;
                ctx.cur_call = 0;
                ctx.band_base = X;
            }
            x_cm = quant_band(&ctx, X, N, b / 2, B,
                              effective_lowband != -1
                                  ? norm + effective_lowband : 0,
                              LM,
                              last ? 0 : norm + M * eBands[i] - norm_offset,
                              1.0, lowband_scratch, x_cm);
            if (T) {
                ctx.cur_call = 1;
                ctx.band_base = Y;
            }
            y_cm = quant_band(&ctx, Y, N, b / 2, B,
                              effective_lowband != -1
                                  ? norm2 + effective_lowband : 0,
                              LM,
                              last ? 0 : norm2 + M * eBands[i] - norm_offset,
                              1.0, lowband_scratch, y_cm);
        }
        else {
            if (Y) {
                if (T) {
                    ctx.cur_call = 0;
                    ctx.band_base = X;
                }
                x_cm = quant_band_stereo(
                    &ctx, X, Y, N, b, B,
                    effective_lowband != -1 ? norm + effective_lowband : 0,
                    LM, last ? 0 : norm + M * eBands[i] - norm_offset,
                    lowband_scratch, x_cm | y_cm);
            }
            else {
                if (T) {
                    T->bd_mode[frame_idx * nbEBands + i] = 1;
                    ctx.cur_call = 0;
                    ctx.band_base = X;
                }
                x_cm = quant_band(
                    &ctx, X, N, b, B,
                    effective_lowband != -1 ? norm + effective_lowband : 0,
                    LM, last ? 0 : norm + M * eBands[i] - norm_offset, 1.0,
                    lowband_scratch, x_cm | y_cm);
            }
            y_cm = x_cm;
        }
        collapse_masks[i * C + 0] = (uint8_t)x_cm;
        collapse_masks[i * C + C - 1] = (uint8_t)y_cm;
        balance += pulses[i] + tell;
        update_lowband = b > (N << BITRES);
    }

    ec[0] = dec.offs;
    ec[1] = dec.end_offs;
    ec[2] = (int64_t)dec.end_window;
    ec[3] = dec.nend_bits;
    ec[4] = dec.nbits_total;
    ec[5] = dec.rng;
    ec[6] = dec.rem;
    ec[7] = dec.val;
    ec[8] = dec.ext;
    ec[9] = dec.error;
    return ctx.seed;
}

uint32_t celt_bands_decode(
    const uint8_t *buf, uint32_t storage, int64_t *ec,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const int16_t *cache_index, const uint8_t *cache_bits,
    int start, int end, int shortBlocks, int spread, int dual_stereo,
    int intensity, const int32_t *tf_res, int64_t total_bits,
    int64_t balance, const int32_t *pulses, int LM, int codedBands,
    uint32_t seed, int C, double *X_, uint8_t *collapse_masks)
{
    return celt_bands_decode_i(
        buf, storage, ec, eBands, nbEBands, logN, cache_index, cache_bits,
        start, end, shortBlocks, spread, dual_stereo, intensity, tf_res,
        total_bits, balance, pulses, LM, codedBands, seed, C, X_,
        collapse_masks, 0, 0, 0);
}

/* ---------------- allocation (rate.c port of our Python) ---------- */

#define ALLOC_STEPS 6
#define MAX_FINE_BITS 8
#define FINE_OFFSET 21

static const int LOG2_FRAC[25] = {0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28,
                                  29, 30, 31, 32, 32, 33, 34, 34, 35, 36,
                                  36, 37, 37, 38};

/* ec state array layout identical to celt_bands_decode */
void celt_compute_allocation(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const uint8_t *allocVectors, int nbAllocVectors,
    const int32_t *cap, const int32_t *offsets,
    int start, int end, int alloc_trim, int64_t total_in, int C, int LM,
    /* outputs */
    int32_t *pulses, int32_t *ebits, int32_t *fine_priority,
    int32_t *result /* [codedBands, balance_lo64?? -> use 2 slots],
                       layout: codedBands, intensity, dual, balance */)
{
    ecdec dec;
    int64_t total = total_in;
    int skip_start = start;
    int skip_rsv, intensity_rsv = 0, dual_stereo_rsv = 0;
    int thresh[32], trim_offset[32], bits1[32], bits2[32], bits[32];
    int lo, hi, j, codedBands, intensity = 0, dual_stereo = 0;
    int alloc_floor = C << BITRES;
    int stereo = C > 1 ? 1 : 0;
    int logM = LM << BITRES;
    int64_t psum, balance;
    int left, percoeff, done;

    dec.buf = buf;
    dec.storage = storage;
    dec.offs = (uint32_t)ecst[0];
    dec.end_offs = (uint32_t)ecst[1];
    dec.end_window = (uint64_t)ecst[2];
    dec.nend_bits = (int)ecst[3];
    dec.nbits_total = (int)ecst[4];
    dec.rng = (uint32_t)ecst[5];
    dec.rem = (int)ecst[6];
    dec.val = (uint32_t)ecst[7];
    dec.ext = (uint32_t)ecst[8];
    dec.error = (int)ecst[9];

    if (total < 0) total = 0;
    skip_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
    total -= skip_rsv;
    if (C == 2) {
        intensity_rsv = LOG2_FRAC[end - start];
        if (intensity_rsv > total) intensity_rsv = 0;
        else {
            total -= intensity_rsv;
            dual_stereo_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
            total -= dual_stereo_rsv;
        }
    }

    for (j = start; j < end; j++) {
        int N = eBands[j + 1] - eBands[j];
        int t = (3 * N << LM << BITRES) >> 4;
        thresh[j] = t > (C << BITRES) ? t : (C << BITRES);
        trim_offset[j] = (C * N * (alloc_trim - 5 - LM) * (end - j - 1)
                          * (1 << (LM + BITRES))) >> 6;
        if ((N << LM) == 1) trim_offset[j] -= C << BITRES;
    }

    lo = 1;
    hi = nbAllocVectors - 1;
    while (lo <= hi) {
        int mid = (lo + hi) >> 1;
        done = 0;
        psum = 0;
        for (j = end - 1; j >= start; j--) {
            int N = eBands[j + 1] - eBands[j];
            int bitsj = (C * N * allocVectors[mid * nbEBands + j]
                         << LM) >> 2;
            if (bitsj > 0) {
                bitsj += trim_offset[j];
                if (bitsj < 0) bitsj = 0;
            }
            bitsj += offsets[j];
            if (bitsj >= thresh[j] || done) {
                done = 1;
                psum += bitsj < cap[j] ? bitsj : cap[j];
            }
            else if (bitsj >= alloc_floor)
                psum += alloc_floor;
        }
        if (psum > total) hi = mid - 1;
        else lo = mid + 1;
    }
    hi = lo;
    lo--;
    for (j = start; j < end; j++) {
        int N = eBands[j + 1] - eBands[j];
        int bits1j = (C * N * allocVectors[lo * nbEBands + j] << LM) >> 2;
        int bits2j = hi >= nbAllocVectors ? cap[j]
            : (C * N * allocVectors[hi * nbEBands + j] << LM) >> 2;
        if (bits1j > 0) {
            bits1j += trim_offset[j];
            if (bits1j < 0) bits1j = 0;
        }
        if (bits2j > 0) {
            bits2j += trim_offset[j];
            if (bits2j < 0) bits2j = 0;
        }
        if (lo > 0) bits1j += offsets[j];
        bits2j += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        bits2j -= bits1j;
        if (bits2j < 0) bits2j = 0;
        bits1[j] = bits1j;
        bits2[j] = bits2j;
    }

    /* interp_bits2pulses */
    lo = 0;
    hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        psum = 0;
        done = 0;
        for (j = end - 1; j >= start; j--) {
            int tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
            if (tmp >= thresh[j] || done) {
                done = 1;
                psum += tmp < cap[j] ? tmp : cap[j];
            }
            else if (tmp >= alloc_floor)
                psum += alloc_floor;
        }
        if (psum > total) hi = mid;
        else lo = mid;
    }
    psum = 0;
    done = 0;
    for (j = end - 1; j >= start; j--) {
        int tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
        if (tmp < thresh[j] && !done)
            tmp = tmp >= alloc_floor ? alloc_floor : 0;
        else
            done = 1;
        tmp = tmp < cap[j] ? tmp : cap[j];
        bits[j] = tmp;
        psum += tmp;
    }

    codedBands = end;
    for (;;) {
        int band_bits, band_width, rem;
        j = codedBands - 1;
        if (j <= skip_start) {
            total += skip_rsv;
            break;
        }
        left = (int)(total - psum);
        percoeff = left / (eBands[codedBands] - eBands[start]);
        left -= (eBands[codedBands] - eBands[start]) * percoeff;
        rem = left - (eBands[j] - eBands[start]);
        if (rem < 0) rem = 0;
        band_width = eBands[codedBands] - eBands[j];
        band_bits = bits[j] + percoeff * band_width + rem;
        {
            int th = thresh[j] > alloc_floor + (1 << BITRES)
                ? thresh[j] : alloc_floor + (1 << BITRES);
            if (band_bits >= th) {
                if (ec_dec_bit_logp(&dec, 1))
                    break;
                psum += 1 << BITRES;
                band_bits -= 1 << BITRES;
            }
        }
        psum -= bits[j] + intensity_rsv;
        if (intensity_rsv > 0)
            intensity_rsv = LOG2_FRAC[j - start];
        psum += intensity_rsv;
        if (band_bits >= alloc_floor) {
            psum += alloc_floor;
            bits[j] = alloc_floor;
        }
        else
            bits[j] = 0;
        codedBands--;
    }

    if (intensity_rsv > 0)
        intensity = start + (int)ec_dec_uint(&dec, codedBands + 1 - start);
    else
        intensity = 0;
    if (intensity <= start) {
        total += dual_stereo_rsv;
        dual_stereo_rsv = 0;
    }
    dual_stereo = dual_stereo_rsv > 0 ? ec_dec_bit_logp(&dec, 1) : 0;

    left = (int)(total - psum);
    percoeff = left / (eBands[codedBands] - eBands[start]);
    left -= (eBands[codedBands] - eBands[start]) * percoeff;
    for (j = start; j < codedBands; j++)
        bits[j] += percoeff * (eBands[j + 1] - eBands[j]);
    for (j = start; j < codedBands; j++) {
        int tmp = left < (eBands[j + 1] - eBands[j])
            ? left : (eBands[j + 1] - eBands[j]);
        bits[j] += tmp;
        left -= tmp;
    }

    balance = 0;
    for (j = start; j < codedBands; j++) {
        int N0 = eBands[j + 1] - eBands[j];
        int N = N0 << LM;
        int64_t bit = (int64_t)bits[j] + balance;
        int excess = 0;
        if (N > 1) {
            int den, NClogN, offset2;
            excess = (int)(bit - cap[j]);
            if (excess < 0) excess = 0;
            bits[j] = (int)(bit - excess);
            den = C * N + ((C == 2 && N > 2 && !dual_stereo
                            && j < intensity) ? 1 : 0);
            NClogN = den * (logN[j] + logM);
            offset2 = (NClogN >> 1) - den * FINE_OFFSET;
            if (N == 2) offset2 += den << BITRES >> 2;
            if (bits[j] + offset2 < (den * 2) << BITRES)
                offset2 += NClogN >> 2;
            else if (bits[j] + offset2 < (den * 3) << BITRES)
                offset2 += NClogN >> 3;
            {
                int eb = (bits[j] + offset2 + (den << (BITRES - 1)))
                         / (den << BITRES);
                if (eb < 0) eb = 0;
                if (C * eb > (bits[j] >> BITRES))
                    eb = bits[j] >> stereo >> BITRES;
                if (eb > MAX_FINE_BITS) eb = MAX_FINE_BITS;
                ebits[j] = eb;
                fine_priority[j] =
                    eb * (den << BITRES) >= bits[j] + offset2;
                bits[j] -= C * eb << BITRES;
            }
        }
        else {
            excess = (int)(bit - (C << BITRES));
            if (excess < 0) excess = 0;
            bits[j] = (int)(bit - excess);
            ebits[j] = 0;
            fine_priority[j] = 1;
        }
        if (excess > 0) {
            int extra_fine = excess >> (stereo + BITRES);
            int extra_bits;
            if (extra_fine > MAX_FINE_BITS - ebits[j])
                extra_fine = MAX_FINE_BITS - ebits[j];
            ebits[j] += extra_fine;
            extra_bits = extra_fine * C << BITRES;
            fine_priority[j] = extra_bits >= excess - (int)balance;
            excess -= extra_bits;
        }
        balance = excess;
    }
    for (j = codedBands; j < end; j++) {
        ebits[j] = bits[j] >> stereo >> BITRES;
        bits[j] = 0;
        fine_priority[j] = ebits[j] < 1;
    }
    for (j = start; j < end; j++) pulses[j] = bits[j];

    ecst[0] = dec.offs;
    ecst[1] = dec.end_offs;
    ecst[2] = (int64_t)dec.end_window;
    ecst[3] = dec.nend_bits;
    ecst[4] = dec.nbits_total;
    ecst[5] = dec.rng;
    ecst[6] = dec.rem;
    ecst[7] = dec.val;
    ecst[8] = dec.ext;
    ecst[9] = dec.error;
    result[0] = codedBands;
    result[1] = intensity;
    result[2] = dual_stereo;
    result[3] = (int32_t)balance;
}

/* --------------- energy envelope + tf_decode (quant_bands.c) -----------
 * C translations of unquant_coarse_energy / unquant_fine_energy /
 * unquant_energy_finalise (reference: celt/quant_bands.c:427-550) and
 * tf_decode (celt_decoder_clean.c:314-351), same ec-state handoff as
 * celt_bands_decode above. */

/* laplace.c ec_laplace_decode with LOG_MINP=0 (MINP=1), NMIN=16 */
static int ec_laplace_decode(ecdec *d, unsigned fs, int decay) {
    int val = 0;
    unsigned fl = 0;
    unsigned fm = ec_decode_bin(d, 15);
    if (fm >= fs) {
        val++;
        fl = fs;
        fs = (unsigned)(((32768 - 32 - (int)fs) * (16384 - decay)) >> 15) + 1;
        while (fs > 1 && fm >= fl + 2 * fs) {
            fs *= 2;
            fl += fs;
            fs = (unsigned)(((int)(fs - 2) * decay) >> 15);
            fs += 1;
            val++;
        }
        if (fs <= 1) {
            int di = (int)(fm - fl) >> 1;
            val += di;
            fl += 2u * (unsigned)di;
        }
        if (fm < fl + fs) val = -val;
        else fl += fs;
    }
    ec_update(d, fl, fl + fs < 32768 ? fl + fs : 32768, 32768);
    return val;
}

void celt_coarse_energy(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    const int32_t *prob_model /* [42] for this (LM, intra) */,
    int start, int end, double *oldEBands /* [2*nbE] */, int nbE,
    int intra, int C, int LM)
{
    static const double pred_coef[4] = {
        29440 / 32768.0, 26112 / 32768.0, 21248 / 32768.0, 16384 / 32768.0};
    static const double beta_coef[4] = {
        30147 / 32768.0, 22282 / 32768.0, 12124 / 32768.0, 6554 / 32768.0};
    static const uint8_t small_energy_icdf[3] = {2, 1, 0};
    ecdec dec;
    double coef, beta;
    double prev[2] = {0.0, 0.0};
    int64_t budget = (int64_t)storage * 8;
    int i, c;

    ec_load(&dec, buf, storage, ecst);
    if (intra) { coef = 0.0; beta = 4915 / 32768.0; }
    else { coef = pred_coef[LM]; beta = beta_coef[LM]; }
    for (i = start; i < end; i++) {
        for (c = 0; c < C; c++) {
            int64_t tell = ec_tell(&dec);
            int qi;
            double q, old, tmp;
            if (budget - tell >= 15) {
                int pi = 2 * (i < 20 ? i : 20);
                qi = ec_laplace_decode(
                    &dec, (unsigned)prob_model[pi] << 7,
                    prob_model[pi + 1] << 6);
            } else if (budget - tell >= 2) {
                qi = ec_dec_icdf(&dec, small_energy_icdf, 2);
                qi = (qi >> 1) ^ -(qi & 1);
            } else if (budget - tell >= 1) {
                qi = -ec_dec_bit_logp(&dec, 1);
            } else {
                qi = -1;
            }
            q = (double)qi;
            old = oldEBands[c * nbE + i];
            if (old < -9.0) old = -9.0;
            tmp = coef * old + prev[c] + q;
            oldEBands[c * nbE + i] = tmp;
            prev[c] = prev[c] + q - beta * q;
        }
    }
    ec_store(&dec, ecst);
}

void celt_fine_energy(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    const int32_t *fine_quant, double *oldEBands, int nbE,
    int start, int end, int C)
{
    ecdec dec;
    int i, c;
    ec_load(&dec, buf, storage, ecst);
    for (i = start; i < end; i++) {
        if (fine_quant[i] <= 0) continue;
        for (c = 0; c < C; c++) {
            uint32_t q2 = ec_dec_bits(&dec, (unsigned)fine_quant[i]);
            double offset =
                (q2 + 0.5) * (double)(1 << (14 - fine_quant[i])) / 16384.0
                - 0.5;
            oldEBands[c * nbE + i] += offset;
        }
    }
    ec_store(&dec, ecst);
}

/* returns bits_left after consumption */
int64_t celt_energy_finalise(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    const int32_t *fine_quant, const int32_t *fine_priority,
    int64_t bits_left, double *oldEBands, int nbE,
    int start, int end, int C)
{
    ecdec dec;
    int prio, i, c;
    ec_load(&dec, buf, storage, ecst);
    for (prio = 0; prio < 2; prio++) {
        for (i = start; i < end && bits_left >= C; i++) {
            if (fine_quant[i] >= 8 /* MAX_FINE_BITS */
                || fine_priority[i] != prio)
                continue;
            for (c = 0; c < C; c++) {
                uint32_t q2 = ec_dec_bits(&dec, 1);
                double offset = ((double)q2 - 0.5)
                    * (double)(1 << (14 - fine_quant[i] - 1)) / 16384.0;
                oldEBands[c * nbE + i] += offset;
                bits_left--;
            }
        }
    }
    ec_store(&dec, ecst);
    return bits_left;
}

void celt_tf_decode(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    int start, int end, int isTransient, int32_t *tf_res, int LM)
{
    static const int tf_select_table[4][8] = {
        {0, -1, 0, -1, 0, -1, 0, -1},
        {0, -1, 0, -2, 1, 0, 1, -1},
        {0, -2, 0, -3, 2, 0, 1, -1},
        {0, -2, 0, -3, 3, 0, 1, -1},
    };
    ecdec dec;
    int64_t budget, tell;
    int logp, tf_select_rsv, tf_changed = 0, curr = 0, tf_select = 0;
    int base, i;

    ec_load(&dec, buf, storage, ecst);
    budget = (int64_t)storage * 8;
    tell = ec_tell(&dec);
    logp = isTransient ? 2 : 4;
    tf_select_rsv = (LM > 0 && tell + logp + 1 <= budget) ? 1 : 0;
    budget -= tf_select_rsv;
    for (i = start; i < end; i++) {
        if (tell + logp <= budget) {
            curr ^= ec_dec_bit_logp(&dec, logp);
            tell = ec_tell(&dec);
            tf_changed |= curr;
        }
        tf_res[i] = curr;
        logp = isTransient ? 4 : 5;
    }
    base = isTransient ? 4 : 0;
    if (tf_select_rsv
        && tf_select_table[LM][base + 0 + tf_changed]
           != tf_select_table[LM][base + 2 + tf_changed])
        tf_select = ec_dec_bit_logp(&dec, 1);
    for (i = start; i < end; i++)
        tf_res[i] = tf_select_table[LM][base + 2 * tf_select + tf_res[i]];
    ec_store(&dec, ecst);
}

/* Dynalloc boost loop + alloc trim (celt_decoder_clean.c:481-529): the
 * per-band tell_frac/dec_bit_logp loop, the densest remaining ec section.
 * Returns the updated total_bits (Q3); writes offsets[start..end) and
 * trim_out[0]. */
int64_t celt_dynalloc(
    const uint8_t *buf, uint32_t storage, int64_t *ecst,
    const int16_t *eBands, int start, int end, int C, int LM,
    const int32_t *cap, int64_t total_bits,
    int32_t *offsets, int32_t *trim_out)
{
    static const uint8_t trim_icdf[11] =
        {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
    ecdec dec;
    int dynalloc_logp = 6;
    int64_t tell;
    int i;

    ec_load(&dec, buf, storage, ecst);
    tell = ec_tell_frac(&dec);
    for (i = start; i < end; i++) {
        int width = (C * (eBands[i + 1] - eBands[i])) << LM;
        int qa = width << BITRES;
        int qb = (6 << BITRES) > width ? (6 << BITRES) : width;
        int quanta = qa < qb ? qa : qb;
        int dll = dynalloc_logp;
        int boost = 0;
        while (tell + ((int64_t)dll << BITRES) < total_bits
               && boost < cap[i]) {
            int flag = ec_dec_bit_logp(&dec, (unsigned)dll);
            tell = ec_tell_frac(&dec);
            if (!flag) break;
            boost += quanta;
            total_bits -= quanta;
            dll = 1;
        }
        offsets[i] = boost;
        if (boost > 0)
            dynalloc_logp = dynalloc_logp - 1 > 2 ? dynalloc_logp - 1 : 2;
    }
    trim_out[0] = 5;
    if (tell + (6 << BITRES) <= total_bits)
        trim_out[0] = ec_dec_icdf(&dec, trim_icdf, 7);
    ec_store(&dec, ecst);
    return total_bits;
}

/* ================================================================== */
/* Whole-stream frame driver: the entire CELT entropy half in one     */
/* native call per stream (reference orchestration:                   */
/* celt_decoder_clean.c:353-724 celt_decode_with_ec).  The Python     */
/* layer keeps a per-stage fallback; this driver exists because with  */
/* a single host core the per-frame Python/ctypes overhead bounds     */
/* end-to-end decode throughput (SURVEY.md §7 "host decode            */
/* throughput").                                                      */
/* ================================================================== */

/* bands.c anti_collapse (decode side); trace mode (T != NULL) emits
   (frame, band, c, k, seed, r) records and only advances the LCG. */
static uint32_t anti_collapse_c_i(
    const int16_t *eBands, int nbE, double *X_,
    const uint8_t *collapse_masks, int LM, int C, int size,
    int start, int end, const double *logE, const double *prev1logE,
    const double *prev2logE, const int32_t *pulses, uint32_t seed,
    tracectx *T, int64_t frame_idx)
{
    int i, c, j, k;
    for (i = start; i < end; i++) {
        int N0 = eBands[i + 1] - eBands[i];
        int depth = (1 + pulses[i]) / (N0 << LM);
        double thresh = 0.5 * pow(2.0, -0.125 * depth);
        double sqrt_1 = 1.0 / sqrt((double)(N0 << LM));
        for (c = 0; c < C; c++) {
            double prev1 = prev1logE[c * nbE + i];
            double prev2 = prev2logE[c * nbE + i];
            double Ediff, r;
            double *X;
            int renorm = 0;
            if (C == 1) {
                if (prev1logE[nbE + i] > prev1) prev1 = prev1logE[nbE + i];
                if (prev2logE[nbE + i] > prev2) prev2 = prev2logE[nbE + i];
            }
            Ediff = logE[c * nbE + i] - (prev1 < prev2 ? prev1 : prev2);
            if (Ediff < 0.0) Ediff = 0.0;
            r = 2.0 * pow(2.0, -Ediff);
            if (LM == 3) r *= 1.41421356;
            if (r > thresh) r = thresh;
            r *= sqrt_1;
            X = X_ + c * size + ((int)eBands[i] << LM);
            for (k = 0; k < (1 << LM); k++) {
                if (!(collapse_masks[i * C + c] & (1u << k))) {
                    if (T) {
                        if (T->ac_n >= T->ac_cap) { T->err = 1; return seed; }
                        T->ac_frame[T->ac_n] = (int32_t)frame_idx;
                        T->ac_band[T->ac_n] = (int8_t)i;
                        T->ac_c[T->ac_n] = (int8_t)c;
                        T->ac_k[T->ac_n] = (int8_t)k;
                        T->ac_seed[T->ac_n] = seed;
                        T->ac_r[T->ac_n] = (float)r;
                        T->ac_n++;
                        for (j = 0; j < N0; j++) seed = lcg_rand(seed);
                    }
                    else {
                        for (j = 0; j < N0; j++) {
                            seed = lcg_rand(seed);
                            X[(j << LM) + k] = (seed & 0x8000) ? r : -r;
                        }
                    }
                    renorm = 1;
                }
            }
            if (renorm && !T) renormalise_vector(X, N0 << LM, 1.0);
        }
    }
    return seed;
}

static uint32_t anti_collapse_c(
    const int16_t *eBands, int nbE, double *X_,
    const uint8_t *collapse_masks, int LM, int C, int size,
    int start, int end, const double *logE, const double *prev1logE,
    const double *prev2logE, const int32_t *pulses, uint32_t seed)
{
    return anti_collapse_c_i(eBands, nbE, X_, collapse_masks, LM, C, size,
                             start, end, logE, prev1logE, prev2logE,
                             pulses, seed, 0, 0);
}

/* bands.c denormalise_bands for one channel into float32 output */
static void denormalise_c(
    const int16_t *eBands, const double *eMeans, int M,
    const double *X, float *freq, const double *bandLogE_row,
    int start, int end, int N)
{
    int i, j;
    for (j = 0; j < M * eBands[start]; j++) freq[j] = 0.0f;
    for (i = start; i < end; i++) {
        double g = exp(0.6931471805599453094
                       * (bandLogE_row[i] + eMeans[i]));
        for (j = M * eBands[i]; j < M * eBands[i + 1]; j++)
            freq[j] = (float)(X[j] * g);
    }
    for (j = M * eBands[end]; j < N; j++) freq[j] = 0.0f;
}

/* Decode n_frames CELT frames (independent range-coder payloads) into
 * denormalised spectra + postfilter parameters.  State arrays are
 * updated in place, matching formats/opus/celt.py CeltDecoderState.
 *
 *   payload/offs/lens      per-frame byte ranges
 *   frame_sizes            per-frame N (120<<LM)
 *   ends / stream_chs      per-frame end band + coded channels
 *   prob_model_all         int32 [4][2][42] e_prob_model
 *   freq_out               float32 [n_frames, CCout, Nmax]
 * Returns 0, or 1+index of the first frame with a range-coder error. */
static int64_t celt_decode_stream_i(
    const uint8_t *payload, const int64_t *offs, const int64_t *lens,
    const int32_t *frame_sizes, const int32_t *ends,
    const int32_t *stream_chs, int64_t n_frames,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const int16_t *cache_index, const uint8_t *cache_bits,
    const uint8_t *cache_caps, const uint8_t *allocVectors,
    int nbAllocVectors, const double *eMeans,
    const int32_t *prob_model_all, int shortMdctSize, int effEBands,
    double *oldEBands, double *oldLogE, double *oldLogE2,
    double *backgroundLogE, int64_t *rng_io,
    int CC, int CCout, int downsample, int start,
    int32_t nmax, float *freq_out,
    int32_t *out_short_blocks, int32_t *out_pf_pitch,
    double *out_pf_gain, int32_t *out_pf_tapset, int32_t *out_silence,
    tracectx *T, int32_t *fr_misc, float *fr_gains)
{
    static const uint8_t tapset_icdf_c[3] = {2, 1, 0};
    static const uint8_t spread_icdf_c[4] = {25, 23, 2, 0};
    uint32_t rng = (uint32_t)*rng_io;
    int64_t f;

    for (f = 0; f < n_frames; f++) {
        const uint8_t *data = payload + offs[f];
        uint32_t length = (uint32_t)lens[f];
        int frame_size = frame_sizes[f];
        int end = ends[f];
        int C = stream_chs[f];
        int effEnd = end < effEBands ? end : effEBands;
        int LM, M, N, i, c;
        ecdec dec;
        int64_t ecst[10];
        int64_t total_bits, tell, total_q3, bits, anti_collapse_rsv;
        int silence, isTransient, shortBlocks, intra_ener;
        int postfilter_pitch = 0, postfilter_tapset = 0;
        double postfilter_gain = 0.0;
        int spread_decision = 2 /* SPREAD_NORMAL */;
        int32_t cap[32], offsets_a[32], trim_a[1], tf_res[32];
        int32_t pulses[32], fine_quant[32], fine_priority[32], res4[4];
        int codedBands, intensity, dual_stereo;
        int64_t balance;
        double X[2 * 960];
        uint8_t collapse_masks[64];
        float *fout = T ? 0 : freq_out + f * (int64_t)CCout * nmax;
        int anti_collapse_on = 0;
        PROF_T(tf0);

        if (C > CCout) return 1 + f;  /* caller must size CCout >= C */

        for (LM = 0; LM <= 3; LM++)
            if (shortMdctSize << LM == frame_size) break;
        if (LM > 3) return 1 + f;
        M = 1 << LM;
        N = M * shortMdctSize;

        if (C == 1)
            for (i = 0; i < nbEBands; i++)
                if (oldEBands[nbEBands + i] > oldEBands[i])
                    oldEBands[i] = oldEBands[nbEBands + i];

        ec_init(&dec, data, length);
        total_bits = (int64_t)length * 8;
        tell = ec_tell(&dec);
        if (tell >= total_bits) silence = 1;
        else if (tell == 1) silence = ec_dec_bit_logp(&dec, 15);
        else silence = 0;
        if (silence) {
            dec.nbits_total += (int)(total_bits - ec_tell(&dec));
            tell = total_bits;
        } else {
            tell = ec_tell(&dec);
        }

        if (start == 0 && tell + 16 <= total_bits) {
            if (ec_dec_bit_logp(&dec, 1)) {
                int octave = (int)ec_dec_uint(&dec, 6);
                int qg;
                postfilter_pitch =
                    (16 << octave)
                    + (int)ec_dec_bits(&dec, (unsigned)(4 + octave)) - 1;
                qg = (int)ec_dec_bits(&dec, 3);
                if (ec_tell(&dec) + 2 <= total_bits)
                    postfilter_tapset =
                        ec_dec_icdf(&dec, tapset_icdf_c, 2);
                postfilter_gain = 0.09375 * (qg + 1);
            }
            tell = ec_tell(&dec);
        }

        if (LM > 0 && tell + 3 <= total_bits) {
            isTransient = ec_dec_bit_logp(&dec, 3);
            tell = ec_tell(&dec);
        } else isTransient = 0;
        shortBlocks = isTransient ? M : 0;

        intra_ener = (tell + 3 <= total_bits)
            ? ec_dec_bit_logp(&dec, 3) : 0;

        ec_store(&dec, ecst);
        celt_coarse_energy(
            data, length, ecst,
            prob_model_all + ((int64_t)LM * 2 + (intra_ener ? 1 : 0)) * 42,
            start, end, oldEBands, nbEBands, intra_ener, C, LM);

        celt_tf_decode(data, length, ecst, start, end, isTransient,
                       tf_res, LM);

        ec_load(&dec, data, length, ecst);
        tell = ec_tell(&dec);
        if (tell + 4 <= total_bits)
            spread_decision = ec_dec_icdf(&dec, spread_icdf_c, 5);
        else
            spread_decision = 2;
        ec_store(&dec, ecst);

        for (i = 0; i < nbEBands; i++) {
            int NB = (eBands[i + 1] - eBands[i]) << LM;
            cap[i] = ((int)cache_caps[nbEBands * (2 * LM + C - 1) + i]
                      + 64) * C * NB >> 2;
        }
        total_q3 = total_bits << BITRES;
        total_q3 = celt_dynalloc(data, length, ecst, eBands, start, end,
                                 C, LM, cap, total_q3, offsets_a, trim_a);

        ec_load(&dec, data, length, ecst);
        bits = ((int64_t)length * 8 << BITRES) - ec_tell_frac(&dec) - 1;
        ec_store(&dec, ecst);
        anti_collapse_rsv =
            (isTransient && LM >= 2 && bits >= ((int64_t)(LM + 2) << BITRES))
                ? (1 << BITRES) : 0;
        bits -= anti_collapse_rsv;

        celt_compute_allocation(
            data, length, ecst, eBands, nbEBands, logN, allocVectors,
            nbAllocVectors, cap, offsets_a, start, end, trim_a[0], bits,
            C, LM, pulses, fine_quant, fine_priority, res4);
        codedBands = res4[0];
        intensity = res4[1];
        dual_stereo = res4[2];
        balance = res4[3];

        celt_fine_energy(data, length, ecst, fine_quant, oldEBands,
                         nbEBands, start, end, C);

        int32_t avg_band = -1;
        if (!T) memset(X, 0, sizeof(double) * (size_t)(C * N));
        memset(collapse_masks, 0, sizeof(collapse_masks));
        PROF_ADD(0, tf0);
        PROF_T(tb0);
        rng = celt_bands_decode_i(
            data, length, ecst, eBands, nbEBands, logN, cache_index,
            cache_bits, start, end, shortBlocks, spread_decision,
            dual_stereo, intensity, tf_res,
            (int64_t)length * (8 << BITRES) - anti_collapse_rsv,
            balance, pulses, LM, codedBands, rng, C, X, collapse_masks,
            T, f, &avg_band);
        PROF_ADD(1, tb0);
        PROF_T(tq0);
        if (T && T->err) return -2;
        /* celt_bands_decode packs channel 1 at stride
           N_full = M*eBands[nbEBands] (< N); the rest of this frame
           (anti-collapse, denormalise) uses stride N — repack. */
        if (C == 2 && !T) {
            int N_full = M * eBands[nbEBands];
            if (N_full != N) {
                memmove(X + N, X + N_full,
                        sizeof(double) * (size_t)N_full);
                memset(X + N_full, 0,
                       sizeof(double) * (size_t)(N - N_full));
            }
        }

        if (anti_collapse_rsv > 0) {
            ec_load(&dec, data, length, ecst);
            anti_collapse_on = (int)ec_dec_bits(&dec, 1);
            ec_store(&dec, ecst);
        }

        ec_load(&dec, data, length, ecst);
        tell = ec_tell(&dec);
        ec_store(&dec, ecst);
        celt_energy_finalise(data, length, ecst, fine_quant,
                             fine_priority, (int64_t)length * 8 - tell,
                             oldEBands, nbEBands, start, end, C);

        if (anti_collapse_on) {
            rng = anti_collapse_c_i(eBands, nbEBands, X, collapse_masks,
                                    LM, C, N, start, end, oldEBands,
                                    oldLogE, oldLogE2, pulses, rng, T, f);
            if (T && T->err) return -2;
        }
        /* Next frame's PVQ seed is the range coder's final rng, not the
           PVQ-updated seed (celt_decoder_clean.c:714 st->rng = dec->rng). */
        rng = (uint32_t)ecst[5];

        if (T) {
            /* trace mode: emit denormalise gains + frame metadata; the
               replay does the float plane (denormalise_c analog). */
            float *g = fr_gains + (int64_t)f * 2 * nbEBands;
            if (silence) {
                for (i = 0; i < 2 * nbEBands; i++) oldEBands[i] = -28.0;
            } else {
                for (c = 0; c < C; c++)
                    for (i = start; i < effEnd; i++)
                        g[c * nbEBands + i] = (float)exp(
                            0.6931471805599453094
                            * (oldEBands[c * nbEBands + i] + eMeans[i]));
            }
            fr_misc[f * 6 + 0] = spread_decision;
            fr_misc[f * 6 + 1] = intensity;
            fr_misc[f * 6 + 2] = avg_band;
            fr_misc[f * 6 + 3] = anti_collapse_on;
            fr_misc[f * 6 + 4] = codedBands;
            fr_misc[f * 6 + 5] = dual_stereo;
        }
        else if (silence) {
            for (i = 0; i < 2 * nbEBands; i++) oldEBands[i] = -28.0;
            for (c = 0; c < CCout; c++)
                for (i = 0; i < N; i++) fout[c * nmax + i] = 0.0f;
        } else {
            for (c = 0; c < C; c++)
                denormalise_c(eBands, eMeans, M, X + c * N,
                              fout + c * nmax, oldEBands + c * nbEBands,
                              start, effEnd, N);
            for (c = 0; c < C; c++) {
                int bound = M * eBands[effEnd];
                if (downsample != 1 && N / downsample < bound)
                    bound = N / downsample;
                for (i = bound; i < N; i++) fout[c * nmax + i] = 0.0f;
            }
            if (CC == 2 && C == 1)
                for (i = 0; i < N; i++) fout[nmax + i] = fout[i];
            if (CC == 1 && C == 2)
                for (i = 0; i < N; i++)
                    fout[i] = 0.5f * (fout[i] + fout[nmax + i]);
        }

        /* energy-memory rollover (celt_decoder_clean.c:685-720) */
        if (C == 1)
            for (i = 0; i < nbEBands; i++)
                oldEBands[nbEBands + i] = oldEBands[i];
        if (!isTransient) {
            for (i = 0; i < 2 * nbEBands; i++) {
                double bg = backgroundLogE[i] + M * 0.001;
                oldLogE2[i] = oldLogE[i];
                oldLogE[i] = oldEBands[i];
                backgroundLogE[i] = bg < oldEBands[i] ? bg : oldEBands[i];
            }
        } else {
            for (i = 0; i < 2 * nbEBands; i++)
                if (oldEBands[i] < oldLogE[i]) oldLogE[i] = oldEBands[i];
        }
        for (c = 0; c < 2; c++) {
            for (i = 0; i < start; i++) {
                oldEBands[c * nbEBands + i] = 0.0;
                oldLogE[c * nbEBands + i] = -28.0;
                oldLogE2[c * nbEBands + i] = -28.0;
            }
            for (i = end; i < nbEBands; i++) {
                oldEBands[c * nbEBands + i] = 0.0;
                oldLogE[c * nbEBands + i] = -28.0;
                oldLogE2[c * nbEBands + i] = -28.0;
            }
        }

        out_short_blocks[f] = shortBlocks;
        out_pf_pitch[f] = postfilter_pitch;
        out_pf_gain[f] = postfilter_gain;
        out_pf_tapset[f] = postfilter_tapset;
        out_silence[f] = silence;
        PROF_ADD(4, tq0);
    }
    *rng_io = rng;
    return 0;
}

int64_t celt_decode_stream(
    const uint8_t *payload, const int64_t *offs, const int64_t *lens,
    const int32_t *frame_sizes, const int32_t *ends,
    const int32_t *stream_chs, int64_t n_frames,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const int16_t *cache_index, const uint8_t *cache_bits,
    const uint8_t *cache_caps, const uint8_t *allocVectors,
    int nbAllocVectors, const double *eMeans,
    const int32_t *prob_model_all, int shortMdctSize, int effEBands,
    double *oldEBands, double *oldLogE, double *oldLogE2,
    double *backgroundLogE, int64_t *rng_io,
    int CC, int CCout, int downsample, int start,
    int32_t nmax, float *freq_out,
    int32_t *out_short_blocks, int32_t *out_pf_pitch,
    double *out_pf_gain, int32_t *out_pf_tapset, int32_t *out_silence)
{
    return celt_decode_stream_i(
        payload, offs, lens, frame_sizes, ends, stream_chs, n_frames,
        eBands, nbEBands, logN, cache_index, cache_bits, cache_caps,
        allocVectors, nbAllocVectors, eMeans, prob_model_all,
        shortMdctSize, effEBands, oldEBands, oldLogE, oldLogE2,
        backgroundLogE, rng_io, CC, CCout, downsample, start, nmax,
        freq_out, out_short_blocks, out_pf_pitch, out_pf_gain,
        out_pf_tapset, out_silence, 0, 0, 0);
}

/* iy-split trace entry (DESIGN_iy_split.md): same entropy decode, no
 * float value plane; emits the replay trace instead of freq spectra.
 * tcaps[0..2] = leaf/iy/anti-collapse capacities in, [3..5] = counts
 * out.  Returns 0, 1+frame on range-coder error, -2 on overflow. */
int64_t celt_decode_stream_trace(
    const uint8_t *payload, const int64_t *offs, const int64_t *lens,
    const int32_t *frame_sizes, const int32_t *ends,
    const int32_t *stream_chs, int64_t n_frames,
    const int16_t *eBands, int nbEBands, const int16_t *logN,
    const int16_t *cache_index, const uint8_t *cache_bits,
    const uint8_t *cache_caps, const uint8_t *allocVectors,
    int nbAllocVectors, const double *eMeans,
    const int32_t *prob_model_all, int shortMdctSize, int effEBands,
    double *oldEBands, double *oldLogE, double *oldLogE2,
    double *backgroundLogE, int64_t *rng_io,
    int CC, int CCout, int downsample, int start,
    int32_t *out_short_blocks, int32_t *out_pf_pitch,
    double *out_pf_gain, int32_t *out_pf_tapset, int32_t *out_silence,
    int64_t *tcaps,
    int32_t *lf_frame, int8_t *lf_band, int8_t *lf_call, int8_t *lf_type,
    int16_t *lf_off, int16_t *lf_len, int32_t *lf_k, int16_t *lf_stride,
    double *lf_gain, uint32_t *lf_seed, int64_t *lf_iy_off,
    int16_t *iy_heap,
    uint8_t *bd_mode, int32_t *bd_eff_lb, int8_t *bd_tf,
    int16_t *bd_imid, int16_t *bd_iside, int16_t *bd_itheta,
    int8_t *bd_inv, int8_t *bd_sign, int8_t *bd_cflag,
    int32_t *ac_frame, int8_t *ac_band, int8_t *ac_c, int8_t *ac_k,
    uint32_t *ac_seed, float *ac_r,
    int32_t *fr_misc, float *fr_gains,
    float *xs_dense, int32_t xs_nmax,
    int32_t *rot_row, int32_t *rot_col, int32_t *rot_pk,
    float *rot_th, float *rot_g, int32_t *rot_leaf)
{
    tracectx T;
    int64_t rc;
    memset(&T, 0, sizeof(T));
    T.lf_cap = tcaps[0];
    T.iy_cap = tcaps[1];
    T.ac_cap = tcaps[2];
    T.lf_frame = lf_frame; T.lf_band = lf_band; T.lf_call = lf_call;
    T.lf_type = lf_type; T.lf_off = lf_off; T.lf_len = lf_len;
    T.lf_k = lf_k; T.lf_stride = lf_stride; T.lf_gain = lf_gain;
    T.lf_seed = lf_seed; T.lf_iy_off = lf_iy_off;
    T.iy_heap = tcaps[1] > 0 ? iy_heap : 0;
    T.bd_mode = bd_mode; T.bd_eff_lb = bd_eff_lb; T.bd_tf = bd_tf;
    T.bd_imid = bd_imid; T.bd_iside = bd_iside; T.bd_itheta = bd_itheta;
    T.bd_inv = bd_inv; T.bd_sign = bd_sign; T.bd_cflag = bd_cflag;
    T.ac_frame = ac_frame; T.ac_band = ac_band; T.ac_c = ac_c;
    T.ac_k = ac_k; T.ac_seed = ac_seed; T.ac_r = ac_r;
    T.xs = xs_dense; T.xs_nmax = xs_nmax;
    /* tcaps[6] (if provided: caller passes >= 8 slots) = mode flags;
       bit 0 selects the raw-iy plane (device-side rotation).  When
       rot_row != NULL the caller passes >= 10 slots: tcaps[7] =
       rotation-marker capacity in / count out, tcaps[8] = sigma2
       bitmask out. */
    T.raw_iy = (int32_t)(tcaps[6] & 1);
    /* bit 1: heap-only value emission (no dense xs plane writes);
       requires raw_iy and a heap (iy_cap > 0). */
    T.xs_heap = (int32_t)((tcaps[6] >> 1) & 1) && T.raw_iy
                && T.iy_heap != 0;
    /* bit 2: device cwrsi for B<=1 leaves (LF_PVQ_IDX) */
    T.idx_mode = (int32_t)((tcaps[6] >> 2) & 1) && T.xs_heap;
    if (T.raw_iy && rot_row) {
        T.rot_row = rot_row; T.rot_col = rot_col; T.rot_pk = rot_pk;
        T.rot_th = rot_th; T.rot_g = rot_g;
        T.rot_leaf = T.idx_mode ? rot_leaf : 0;
        T.rot_cap = tcaps[7];
    }
    rc = celt_decode_stream_i(
        payload, offs, lens, frame_sizes, ends, stream_chs, n_frames,
        eBands, nbEBands, logN, cache_index, cache_bits, cache_caps,
        allocVectors, nbAllocVectors, eMeans, prob_model_all,
        shortMdctSize, effEBands, oldEBands, oldLogE, oldLogE2,
        backgroundLogE, rng_io, CC, CCout, downsample, start, 0, 0,
        out_short_blocks, out_pf_pitch, out_pf_gain, out_pf_tapset,
        out_silence, &T, fr_misc, fr_gains);
    tcaps[3] = T.lf_n;
    tcaps[4] = T.iy_n;
    tcaps[5] = T.ac_n;
    if (T.rot_row) {
        tcaps[7] = T.rot_n;
        tcaps[8] = (int64_t)T.rot_sigmas;
    }
    if (T.err) return -2;
    return rc;
}
