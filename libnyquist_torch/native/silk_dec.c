/* Native SILK decoder: full fixed-point decode to 48 kHz int16.
 *
 * The SILK half of every SILK-only and hybrid Opus frame, and its loss
 * concealment (RFC 6716 §4.2; reference: silk/ dec_API.c,
 * decode_frame.c, decode_core.c, decode_pulses.c, NLSF_decode.c,
 * NLSF2A.c, resampler*.c, PLC.c, CNG.c). Host work by nature: per-symbol
 * range decoding and per-sample fixed-point recurrences.
 *
 * SILK is specified in integer arithmetic, so this is bit-exact with the
 * reference: int64 intermediates with explicit int32 wraps where the
 * reference's macros wrap.
 *
 * Decoder state lives natively behind an opaque handle (silk_create /
 * silk_decode / silk_decode_lost / silk_free); only the shared
 * range-coder state crosses the boundary per call (10 int64s, the
 * layout of celt_bands.c). Normative tables are not compiled in:
 * formats/opus/silk.py loads data/silk.tbl and hands the blobs over
 * once via silk_set_tables.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "ecdec.h"

/* ---------------- fixed-point helpers ----------- */

static inline int64_t I32(int64_t x) { return (int32_t)(uint64_t)x; }
static inline int64_t I16(int64_t x) { return (int16_t)(uint64_t)x; }

static inline int64_t SAT16(int64_t x) {
    return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

static inline int64_t SMULWB(int64_t a, int64_t b) {
    return (a * I16(b)) >> 16;
}

static inline int64_t SMLAWB(int64_t a, int64_t b, int64_t c) {
    return a + ((b * I16(c)) >> 16);
}

static inline int64_t SMULBB(int64_t a, int64_t b) {
    return I16(a) * I16(b);
}

static inline int64_t SMLABB(int64_t a, int64_t b, int64_t c) {
    return a + I16(b) * I16(c);
}

static inline int64_t SMULWT(int64_t a, int64_t b) {
    return (a >> 16) * (b >> 16) + (((a & 0xFFFF) * (b >> 16)) >> 16);
}

static inline int64_t SMMUL(int64_t a, int64_t b) {
    return I32((a * b) >> 32);
}

static inline int64_t RSHIFT_ROUND(int64_t a, int shift) {
    if (shift == 1) return (a >> 1) + (a & 1);
    return ((a >> (shift - 1)) + 1) >> 1;
}

static inline int64_t SMULWW(int64_t a, int64_t b) {
    return I32(SMULWB(a, b) + I32(a * RSHIFT_ROUND(b, 16)));
}

static inline int64_t SMLAWW(int64_t a, int64_t b, int64_t c) {
    return I32(SMLAWB(a, b, c) + I32(b * RSHIFT_ROUND(c, 16)));
}

static inline int CLZ32(int64_t x) {
    uint32_t v = (uint32_t)(uint64_t)x;
    return v ? __builtin_clz(v) : 32;
}

static inline int64_t CDIV(int64_t a, int64_t b) { return a / b; }

static inline int64_t LIMIT(int64_t x, int64_t lo, int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

#define I32_MIN (-(int64_t)0x80000000)
#define I32_MAX ((int64_t)0x7FFFFFFF)

static inline int64_t LSHIFT_SAT32(int64_t a, int shift) {
    int64_t v = a << shift;
    return LIMIT(v, I32_MIN, I32_MAX);
}

static int64_t div32_varq(int64_t a32, int64_t b32, int qres) {
    int a_headrm = CLZ32(a32 < 0 ? -a32 : a32) - 1;
    int64_t a_nrm = I32(a32 << a_headrm);
    int b_headrm = CLZ32(b32 < 0 ? -b32 : b32) - 1;
    int64_t b_nrm = I32(b32 << b_headrm);
    int64_t b_inv = CDIV(I32_MAX >> 2, b_nrm >> 16);
    int64_t result = SMULWB(a_nrm, b_inv);
    int lshift;
    a_nrm = I32(a_nrm - I32(SMMUL(b_nrm, result) << 3));
    result = SMLAWB(result, a_nrm, b_inv);
    lshift = 29 + a_headrm - b_headrm - qres;
    if (lshift < 0) return LSHIFT_SAT32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static int64_t inverse32_varq(int64_t b32, int qres) {
    int b_headrm = CLZ32(b32 < 0 ? -b32 : b32) - 1;
    int64_t b_nrm = I32(b32 << b_headrm);
    int64_t b_inv = CDIV(I32_MAX >> 2, b_nrm >> 16);
    int64_t result = I32(b_inv << 16);
    int64_t err_q32 = I32((((int64_t)1 << 29) - SMULWB(b_nrm, b_inv)) << 3);
    int lshift;
    result = SMLAWW(result, err_q32, b_inv);
    lshift = 61 - b_headrm - qres;
    if (lshift <= 0) return LSHIFT_SAT32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static int64_t silk_log2lin(int64_t in_log_q7) {
    int64_t out, frac_q7, adj;
    if (in_log_q7 < 0) return 0;
    if (in_log_q7 >= 3967) return I32_MAX;
    out = (int64_t)1 << (in_log_q7 >> 7);
    frac_q7 = in_log_q7 & 0x7F;
    adj = SMLAWB(frac_q7, SMULBB(frac_q7, 128 - frac_q7), -174);
    if (in_log_q7 < 2048) out = out + ((out * adj) >> 7);
    else out = I32(out + (out >> 7) * adj);
    return out;
}

static int64_t sqrt_approx(int64_t x) {
    int lz;
    int64_t frac_q7, y;
    if (x <= 0) return 0;
    lz = CLZ32(x);
    frac_q7 = (x >> (24 - lz > 0 ? 24 - lz : 0)) & 0x7F;
    y = (lz & 1) ? 32768 : 46214;
    y >>= lz >> 1;
    y = SMLAWB(y, y, SMULBB(213, frac_q7));
    return y;
}

static inline int64_t silk_rand(int64_t seed) {
    return I32(907633515 + I32(seed * 196314165));
}

/* --------------------- constants ------------------ */

#define MAX_NB_SUBFR 4
#define SUB_FRAME_LENGTH_MS 5
#define LTP_MEM_LENGTH_MS 20
#define LTP_ORDER 5
#define MAX_LPC_ORDER 16
#define MIN_LPC_ORDER 10
#define SHELL_FRAME 16
#define MAX_PULSES 16
#define N_RATE_LEVELS 10
#define QUANT_LEVEL_ADJUST_Q10 80
#define MIN_DELTA_GAIN_QUANT (-4)
#define MAX_DELTA_GAIN_QUANT 36
#define N_LEVELS_QGAIN 64
#define GAIN_OFFSET ((2 * 128) / 6 + 16 * 128)
#define GAIN_INV_SCALE_Q16 ((65536 * (((88 - 2) * 128) / 6)) / (N_LEVELS_QGAIN - 1))
#define NLSF_QUANT_MAX_AMPLITUDE 4
#define NLSF_QUANT_LEVEL_ADJ_Q10 102
#define NLSF_W_Q 2
#define PITCH_EST_MIN_LAG_MS 2
#define PITCH_EST_MAX_LAG_MS 18
#define STEREO_INTERP_LEN_MS 8
#define TYPE_NO_VOICE_ACTIVITY 0
#define TYPE_VOICED 2
#define CODE_INDEPENDENTLY 0
#define CODE_INDEPENDENTLY_NO_LTP_SCALING 1
#define CODE_CONDITIONALLY 2
#define QA_NLSF2A 16
#define QA_INVPRED 24
#define A_LIMIT_Q24 ((int64_t)(0.99975 * (1 << 24) + 0.5))

/* delay_matrix_dec (silk/resampler.c:62-67); rows in 8/12/16 kHz,
   cols out 8/12/16/24/48 kHz */
static const int DELAY_MATRIX_DEC[3][5] = {
    {4, 0, 2, 0, 0},
    {0, 9, 4, 7, 4},
    {0, 3, 12, 7, 7},
};

/* ------------------------ table registry -------------------------- */

enum {
    TU8_TYPE_VAD = 0, TU8_TYPE_NOVAD, TU8_GAIN, TU8_DELTA_GAIN,
    TU8_U3, TU8_U4, TU8_U5, TU8_U6, TU8_U8,
    TU8_NLSF_INTERP, TU8_NLSF_EXT, TU8_PITCH_DELTA, TU8_PITCH_LAG,
    TU8_PC, TU8_PC10, TU8_PC_NB, TU8_PC10_NB,
    TU8_LTP_PER, TU8_LTP_G0, TU8_LTP_G1, TU8_LTP_G2, TU8_LTPSCALE,
    TU8_LBRR2, TU8_LBRR3, TU8_RATE_LEVELS, TU8_PPB, TU8_LSB, TU8_SIGN,
    TU8_SH0, TU8_SH1, TU8_SH2, TU8_SH3,
    TU8_STEREO_JOINT, TU8_STEREO_MID,
    TU8_WB_CB1_ICDF, TU8_WB_EC_ICDF,
    TU8_NBMB_CB1_ICDF, TU8_NBMB_EC_ICDF,
    TU8_COUNT
};

enum {
    T32_LTPSCALES = 0, T32_VQ0, T32_VQ1, T32_VQ2,
    T32_LAGS2, T32_LAGS2_10, T32_LAGS3, T32_LAGS3_10,
    T32_QOFF, T32_STEREO_QUANT, T32_COSTAB,
    T32_WB_SCAL, T32_WB_CB1, T32_WB_PRED, T32_WB_SEL, T32_WB_DMIN,
    T32_NBMB_SCAL, T32_NBMB_CB1, T32_NBMB_PRED, T32_NBMB_SEL,
    T32_NBMB_DMIN, T32_SHOFF, T32_HQ0, T32_HQ1, T32_FIR12,
    T32_COUNT
};

static const uint8_t *TU8[TU8_COUNT];
static const int32_t *T32[T32_COUNT];
static int tables_ready = 0;

typedef struct {
    int nVectors, order;
    int32_t quantStepSize_Q16;
    const int32_t *CB1_NLSF_Q8;   /* [nVectors * order] */
    const uint8_t *CB1_iCDF;      /* [2 * nVectors]     */
    const int32_t *pred_Q8;       /* [2 * (order - 1)]  */
    const int32_t *ec_sel;        /* [nVectors * order/2] */
    const uint8_t *ec_iCDF;       /* [8 * 9]            */
    const int32_t *deltaMin_Q15;  /* [order + 1]        */
} nlsf_cb;

static nlsf_cb CB_WB, CB_NBMB;

void silk_set_tables(const uint8_t *u8blob, const int64_t *u8offs, int nu8,
                     const int32_t *i32blob, const int64_t *i32offs,
                     int n32)
{
    int i;
    if (nu8 != TU8_COUNT || n32 != T32_COUNT) return;
    for (i = 0; i < TU8_COUNT; i++) TU8[i] = u8blob + u8offs[i];
    for (i = 0; i < T32_COUNT; i++) T32[i] = i32blob + i32offs[i];
    CB_WB.nVectors = T32[T32_WB_SCAL][0];
    CB_WB.order = T32[T32_WB_SCAL][1];
    CB_WB.quantStepSize_Q16 = T32[T32_WB_SCAL][2];
    CB_WB.CB1_NLSF_Q8 = T32[T32_WB_CB1];
    CB_WB.CB1_iCDF = TU8[TU8_WB_CB1_ICDF];
    CB_WB.pred_Q8 = T32[T32_WB_PRED];
    CB_WB.ec_sel = T32[T32_WB_SEL];
    CB_WB.ec_iCDF = TU8[TU8_WB_EC_ICDF];
    CB_WB.deltaMin_Q15 = T32[T32_WB_DMIN];
    CB_NBMB.nVectors = T32[T32_NBMB_SCAL][0];
    CB_NBMB.order = T32[T32_NBMB_SCAL][1];
    CB_NBMB.quantStepSize_Q16 = T32[T32_NBMB_SCAL][2];
    CB_NBMB.CB1_NLSF_Q8 = T32[T32_NBMB_CB1];
    CB_NBMB.CB1_iCDF = TU8[TU8_NBMB_CB1_ICDF];
    CB_NBMB.pred_Q8 = T32[T32_NBMB_PRED];
    CB_NBMB.ec_sel = T32[T32_NBMB_SEL];
    CB_NBMB.ec_iCDF = TU8[TU8_NBMB_EC_ICDF];
    CB_NBMB.deltaMin_Q15 = T32[T32_NBMB_DMIN];
    tables_ready = 1;
}

/* ---------------- gains ------------------- */

static void gains_dequant(const int *ind, int *prev_ind_io, int conditional,
                          int nb_subfr, int64_t *gains)
{
    int prev_ind = *prev_ind_io, k;
    for (k = 0; k < nb_subfr; k++) {
        if (k == 0 && !conditional) {
            prev_ind = ind[k] > prev_ind - 16 ? ind[k] : prev_ind - 16;
        }
        else {
            int ind_tmp = ind[k] + MIN_DELTA_GAIN_QUANT;
            int dsst = 2 * MAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN + prev_ind;
            if (ind_tmp > dsst) prev_ind += (ind_tmp << 1) - dsst;
            else prev_ind += ind_tmp;
        }
        prev_ind = (int)LIMIT(prev_ind, 0, N_LEVELS_QGAIN - 1);
        {
            int64_t v = SMULWB(GAIN_INV_SCALE_Q16, prev_ind) + GAIN_OFFSET;
            gains[k] = silk_log2lin(v < 3967 ? v : 3967);
        }
    }
    *prev_ind_io = prev_ind;
}

/* ---------------- NLSF --------------------------- */

static void nlsf_unpack(const nlsf_cb *cb, int cb1_index,
                        int *ec_ix, int *pred_q8)
{
    const int32_t *row = cb->ec_sel + cb1_index * (cb->order / 2);
    int i;
    for (i = 0; i < cb->order; i += 2) {
        int entry = row[i / 2];
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1);
        pred_q8[i] = cb->pred_Q8[i + (entry & 1) * (cb->order - 1)];
        ec_ix[i + 1] =
            ((entry >> 5) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1);
        pred_q8[i + 1] =
            cb->pred_Q8[i + ((entry >> 4) & 1) * (cb->order - 1) + 1];
    }
}

static void nlsf_residual_dequant(const int *indices, const int *pred_q8,
                                  int32_t quant_step_q16, int order,
                                  int64_t *x_q10)
{
    int64_t out_q10 = 0;
    int i;
    for (i = order - 1; i >= 0; i--) {
        int64_t pred_q10 = (out_q10 * I16(pred_q8[i])) >> 8;
        out_q10 = (int64_t)indices[i] << 10;
        if (out_q10 > 0) out_q10 = I16(out_q10 - NLSF_QUANT_LEVEL_ADJ_Q10);
        else if (out_q10 < 0)
            out_q10 = I16(out_q10 + NLSF_QUANT_LEVEL_ADJ_Q10);
        out_q10 = SMLAWB(pred_q10, out_q10, quant_step_q16);
        x_q10[i] = out_q10;
    }
}

static void nlsf_vq_weights_laroia(const int64_t *nlsf_q15, int order,
                                   int64_t *w)
{
    int64_t tmp1, tmp2;
    int k;
    tmp1 = nlsf_q15[0] > 1 ? nlsf_q15[0] : 1;
    tmp1 = CDIV((int64_t)1 << (15 + NLSF_W_Q), tmp1);
    tmp2 = nlsf_q15[1] - nlsf_q15[0] > 1 ? nlsf_q15[1] - nlsf_q15[0] : 1;
    tmp2 = CDIV((int64_t)1 << (15 + NLSF_W_Q), tmp2);
    w[0] = tmp1 + tmp2 < 32767 ? tmp1 + tmp2 : 32767;
    for (k = 1; k < order - 1; k += 2) {
        tmp1 = nlsf_q15[k + 1] - nlsf_q15[k] > 1
            ? nlsf_q15[k + 1] - nlsf_q15[k] : 1;
        tmp1 = CDIV((int64_t)1 << (15 + NLSF_W_Q), tmp1);
        w[k] = tmp1 + tmp2 < 32767 ? tmp1 + tmp2 : 32767;
        tmp2 = nlsf_q15[k + 2] - nlsf_q15[k + 1] > 1
            ? nlsf_q15[k + 2] - nlsf_q15[k + 1] : 1;
        tmp2 = CDIV((int64_t)1 << (15 + NLSF_W_Q), tmp2);
        w[k + 1] = tmp1 + tmp2 < 32767 ? tmp1 + tmp2 : 32767;
    }
    tmp1 = ((int64_t)1 << 15) - nlsf_q15[order - 1] > 1
        ? ((int64_t)1 << 15) - nlsf_q15[order - 1] : 1;
    tmp1 = CDIV((int64_t)1 << (15 + NLSF_W_Q), tmp1);
    w[order - 1] = tmp1 + tmp2 < 32767 ? tmp1 + tmp2 : 32767;
}

static int cmp_i64(const void *a, const void *b) {
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return x < y ? -1 : (x > y ? 1 : 0);
}

static void nlsf_stabilize(int64_t *nlsf, const int32_t *delta_min, int L)
{
    int loop, i, k, I;
    for (loop = 0; loop < 20; loop++) {
        int64_t min_diff = nlsf[0] - delta_min[0];
        int64_t diff;
        I = 0;
        for (i = 1; i < L; i++) {
            diff = nlsf[i] - (nlsf[i - 1] + delta_min[i]);
            if (diff < min_diff) { min_diff = diff; I = i; }
        }
        diff = ((int64_t)1 << 15) - (nlsf[L - 1] + delta_min[L]);
        if (diff < min_diff) { min_diff = diff; I = L; }
        if (min_diff >= 0) return;
        if (I == 0) nlsf[0] = delta_min[0];
        else if (I == L) nlsf[L - 1] = ((int64_t)1 << 15) - delta_min[L];
        else {
            int64_t min_center = 0, max_center = (int64_t)1 << 15, center;
            for (k = 0; k < I; k++) min_center += delta_min[k];
            min_center += delta_min[I] >> 1;
            for (k = L; k > I; k--) max_center -= delta_min[k];
            max_center -= delta_min[I] >> 1;
            center = LIMIT(RSHIFT_ROUND(nlsf[I - 1] + nlsf[I], 1),
                           min_center, max_center);
            nlsf[I - 1] = center - (delta_min[I] >> 1);
            nlsf[I] = nlsf[I - 1] + delta_min[I];
        }
    }
    /* fallback: sort and force deltas */
    qsort(nlsf, (size_t)L, sizeof(int64_t), cmp_i64);
    for (i = 1; i < L; i++)
        if (nlsf[i] < nlsf[i - 1] + delta_min[i])
            nlsf[i] = nlsf[i - 1] + delta_min[i];
    for (i = L - 1; i >= 0; i--) {
        int64_t hi = (i == L - 1)
            ? (((int64_t)1 << 15) - delta_min[L])
            : (nlsf[i + 1] - delta_min[i + 1]);
        if (nlsf[i] > hi) nlsf[i] = hi;
    }
}

static void nlsf_decode(const int *indices, const nlsf_cb *cb,
                        int64_t *nlsf)
{
    int order = cb->order;
    int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
    int64_t res_q10[MAX_LPC_ORDER], w[MAX_LPC_ORDER];
    int i;
    for (i = 0; i < order; i++)
        nlsf[i] = (int64_t)cb->CB1_NLSF_Q8[indices[0] * order + i] << 7;
    nlsf_unpack(cb, indices[0], ec_ix, pred_q8);
    nlsf_residual_dequant(indices + 1, pred_q8, cb->quantStepSize_Q16,
                          order, res_q10);
    nlsf_vq_weights_laroia(nlsf, order, w);
    for (i = 0; i < order; i++) {
        int64_t w_q9 = sqrt_approx(w[i] << (18 - NLSF_W_Q));
        int64_t v = nlsf[i] + CDIV(res_q10[i] << 14, w_q9);
        nlsf[i] = LIMIT(v, 0, 32767);
    }
    nlsf_stabilize(nlsf, cb->deltaMin_Q15, order);
}

/* ---------------- NLSF2A ------------------------- */

static const int ORDERING16[16] =
    {0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1};
static const int ORDERING10[10] = {0, 9, 6, 3, 4, 5, 8, 1, 2, 7};

static void nlsf2a_find_poly(const int64_t *clsf, int dd, int64_t *out)
{
    int k, n;
    out[0] = (int64_t)1 << QA_NLSF2A;
    out[1] = -clsf[0];
    for (k = 1; k < dd; k++) {
        int64_t ftmp = clsf[k];
        out[k + 1] = I32(I32(out[k - 1] << 1)
                         - RSHIFT_ROUND(ftmp * out[k], QA_NLSF2A));
        for (n = k; n > 1; n--)
            out[n] = I32(out[n] + out[n - 2]
                         - RSHIFT_ROUND(ftmp * out[n - 1], QA_NLSF2A));
        out[1] -= ftmp;
    }
}

static void bwexpander_32(int64_t *ar, int d, int64_t chirp_q16)
{
    int64_t chirp_minus_one = chirp_q16 - 65536;
    int i;
    for (i = 0; i < d - 1; i++) {
        ar[i] = SMULWW(chirp_q16, ar[i]);
        chirp_q16 += RSHIFT_ROUND(I32(chirp_q16 * chirp_minus_one), 16);
    }
    ar[d - 1] = SMULWW(chirp_q16, ar[d - 1]);
}

static inline int64_t mul32_frac_q(int64_t a, int64_t b, int q) {
    return I32(RSHIFT_ROUND(a * b, q));
}

static int64_t lpc_inverse_pred_gain(const int64_t *a_q12, int order)
{
    int64_t dc_resp = 0, inv_gain_q30 = (int64_t)1 << 30;
    int64_t anew[MAX_LPC_ORDER], aold[MAX_LPC_ORDER];
    int k, n;
    for (k = 0; k < order; k++) dc_resp += a_q12[k];
    if (dc_resp >= 4096) return 0;
    for (k = 0; k < order; k++)
        anew[k] = a_q12[k] << (QA_INVPRED - 12);
    for (k = order - 1; k > 0; k--) {
        int64_t rc_q31, rc_mult1_q30, rc_mult2;
        int mult2q;
        if (anew[k] > A_LIMIT_Q24 || anew[k] < -A_LIMIT_Q24) return 0;
        rc_q31 = I32(-(anew[k] << (31 - QA_INVPRED)));
        rc_mult1_q30 = ((int64_t)1 << 30) - SMMUL(rc_q31, rc_q31);
        mult2q = 32 - CLZ32(rc_mult1_q30 < 0 ? -rc_mult1_q30
                                             : rc_mult1_q30);
        rc_mult2 = inverse32_varq(rc_mult1_q30, mult2q + 30);
        inv_gain_q30 = I32(SMMUL(inv_gain_q30, rc_mult1_q30) << 2);
        memcpy(aold, anew, sizeof(aold));
        for (n = 0; n < k; n++) {
            int64_t tmp = I32(aold[n]
                              - mul32_frac_q(aold[k - n - 1], rc_q31, 31));
            anew[n] = mul32_frac_q(tmp, rc_mult2, mult2q);
        }
    }
    if (anew[0] > A_LIMIT_Q24 || anew[0] < -A_LIMIT_Q24) return 0;
    {
        int64_t rc_q31 = I32(-(anew[0] << (31 - QA_INVPRED)));
        int64_t rc_mult1_q30 = ((int64_t)1 << 30) - SMMUL(rc_q31, rc_q31);
        inv_gain_q30 = I32(SMMUL(inv_gain_q30, rc_mult1_q30) << 2);
    }
    return inv_gain_q30;
}

static void nlsf2a(const int64_t *nlsf_q15, int d, int64_t *a_q12)
{
    const int32_t *cos_tab = T32[T32_COSTAB];
    const int *ordering = d == 16 ? ORDERING16 : ORDERING10;
    int64_t clsf[MAX_LPC_ORDER];
    int64_t P[MAX_LPC_ORDER / 2 + 1], Q[MAX_LPC_ORDER / 2 + 1];
    int64_t a32_qa1[MAX_LPC_ORDER];
    int64_t ceven[MAX_LPC_ORDER / 2], codd[MAX_LPC_ORDER / 2];
    int64_t maxabs = 0;
    int k, i, idx = 0, dd = d >> 1, it;
    for (k = 0; k < d; k++) {
        int f_int = (int)(nlsf_q15[k] >> 8);
        int64_t f_frac = nlsf_q15[k] - ((int64_t)f_int << 8);
        int64_t cos_val = cos_tab[f_int];
        int64_t delta = cos_tab[f_int + 1] - cos_val;
        clsf[ordering[k]] = RSHIFT_ROUND((cos_val << 8) + delta * f_frac,
                                         20 - QA_NLSF2A);
    }
    for (k = 0; k < dd; k++) {
        ceven[k] = clsf[2 * k];
        codd[k] = clsf[2 * k + 1];
    }
    nlsf2a_find_poly(ceven, dd, P);
    nlsf2a_find_poly(codd, dd, Q);
    for (k = 0; k < dd; k++) {
        int64_t ptmp = P[k + 1] + P[k];
        int64_t qtmp = Q[k + 1] - Q[k];
        a32_qa1[k] = I32(-qtmp - ptmp);
        a32_qa1[d - k - 1] = I32(qtmp - ptmp);
    }
    for (i = 0; i < 10; i++) {
        maxabs = 0;
        idx = 0;
        for (k = 0; k < d; k++) {
            int64_t absval = a32_qa1[k] < 0 ? -a32_qa1[k] : a32_qa1[k];
            if (absval > maxabs) { maxabs = absval; idx = k; }
        }
        maxabs = RSHIFT_ROUND(maxabs, QA_NLSF2A + 1 - 12);
        if (maxabs > 32767) {
            int64_t sc_q16;
            maxabs = maxabs < 163838 ? maxabs : 163838;
            sc_q16 = (int64_t)(0.999 * 65536 + 0.5)
                - CDIV((maxabs - 32767) << 14,
                       I32(maxabs * (idx + 1)) >> 2);
            bwexpander_32(a32_qa1, d, sc_q16);
        }
        else break;
    }
    if (i == 9 && maxabs > 32767) {
        for (k = 0; k < d; k++) {
            a_q12[k] = SAT16(RSHIFT_ROUND(a32_qa1[k], QA_NLSF2A + 1 - 12));
            a32_qa1[k] = a_q12[k] << (QA_NLSF2A + 1 - 12);
        }
    }
    else {
        for (k = 0; k < d; k++)
            a_q12[k] = RSHIFT_ROUND(a32_qa1[k], QA_NLSF2A + 1 - 12);
    }
    for (it = 0; it < 16; it++) {
        if (lpc_inverse_pred_gain(a_q12, d)
            < (int64_t)((1 << 30) / 1e4)) {
            bwexpander_32(a32_qa1, d, 65536 - ((int64_t)2 << it));
            for (k = 0; k < d; k++)
                a_q12[k] = RSHIFT_ROUND(a32_qa1[k], QA_NLSF2A + 1 - 12);
        }
        else break;
    }
}

/* ---------------- pulses ------------------------- */

static void decode_split(ecdec *dec, int p, const uint8_t *table,
                         const int32_t *offsets, int *c1, int *c2)
{
    if (p > 0) {
        *c1 = ec_dec_icdf(dec, table + offsets[p], 8);
        *c2 = p - *c1;
    }
    else { *c1 = 0; *c2 = 0; }
}

static void shell_decoder(ecdec *dec, int pulses4, int *out)
{
    const uint8_t *t0 = TU8[TU8_SH0], *t1 = TU8[TU8_SH1];
    const uint8_t *t2 = TU8[TU8_SH2], *t3 = TU8[TU8_SH3];
    const int32_t *offs = T32[T32_SHOFF];
    int p3a, p3b, p2a, p2b, p1a, p1b;
    decode_split(dec, pulses4, t3, offs, &p3a, &p3b);
    decode_split(dec, p3a, t2, offs, &p2a, &p2b);
    decode_split(dec, p2a, t1, offs, &p1a, &p1b);
    decode_split(dec, p1a, t0, offs, &out[0], &out[1]);
    decode_split(dec, p1b, t0, offs, &out[2], &out[3]);
    decode_split(dec, p2b, t1, offs, &p1a, &p1b);
    decode_split(dec, p1a, t0, offs, &out[4], &out[5]);
    decode_split(dec, p1b, t0, offs, &out[6], &out[7]);
    decode_split(dec, p3b, t2, offs, &p2a, &p2b);
    decode_split(dec, p2a, t1, offs, &p1a, &p1b);
    decode_split(dec, p1a, t0, offs, &out[8], &out[9]);
    decode_split(dec, p1b, t0, offs, &out[10], &out[11]);
    decode_split(dec, p2b, t1, offs, &p1a, &p1b);
    decode_split(dec, p1a, t0, offs, &out[12], &out[13]);
    decode_split(dec, p1b, t0, offs, &out[14], &out[15]);
}

#define MAX_FRAME_LENGTH 320   /* 20 ms at 16 kHz */
#define MAX_ITER ((MAX_FRAME_LENGTH + SHELL_FRAME - 1) / SHELL_FRAME)

static void decode_pulses(ecdec *dec, int signal_type,
                          int quant_offset_type, int frame_length,
                          int *pulses)
{
    int rate_level, iter_, i, k, j;
    int sum_pulses[MAX_ITER], nlshifts[MAX_ITER];
    const uint8_t *cdf;
    rate_level = ec_dec_icdf(
        dec, TU8[TU8_RATE_LEVELS] + (signal_type >> 1) * 9, 8);
    iter_ = frame_length >> 4;
    if (iter_ * SHELL_FRAME < frame_length) iter_++;
    cdf = TU8[TU8_PPB] + rate_level * 18;
    for (i = 0; i < iter_; i++) {
        nlshifts[i] = 0;
        sum_pulses[i] = ec_dec_icdf(dec, cdf, 8);
        while (sum_pulses[i] == MAX_PULSES + 1) {
            int off;
            nlshifts[i]++;
            off = nlshifts[i] == 10 ? 1 : 0;
            sum_pulses[i] = ec_dec_icdf(
                dec, TU8[TU8_PPB] + (N_RATE_LEVELS - 1) * 18 + off, 8);
        }
    }
    memset(pulses, 0, sizeof(int) * (size_t)(iter_ * SHELL_FRAME));
    for (i = 0; i < iter_; i++)
        if (sum_pulses[i] > 0)
            shell_decoder(dec, sum_pulses[i], pulses + i * SHELL_FRAME);
    for (i = 0; i < iter_; i++) {
        if (nlshifts[i] > 0) {
            int nls = nlshifts[i];
            for (k = 0; k < SHELL_FRAME; k++) {
                int abs_q = pulses[i * SHELL_FRAME + k];
                int s;
                for (s = 0; s < nls; s++)
                    abs_q = (abs_q << 1)
                        + ec_dec_icdf(dec, TU8[TU8_LSB], 8);
                pulses[i * SHELL_FRAME + k] = abs_q;
            }
            sum_pulses[i] |= nls << 5;
        }
    }
    /* signs (code_signs.c) */
    {
        int i0 = 7 * (quant_offset_type + (signal_type << 1));
        int nblocks = (frame_length + SHELL_FRAME / 2) >> 4;
        for (i = 0; i < nblocks; i++) {
            int p = sum_pulses[i];
            if (p > 0) {
                uint8_t icdf[2];
                icdf[0] = TU8[TU8_SIGN][
                    i0 + ((p & 0x1F) < 6 ? (p & 0x1F) : 6)];
                icdf[1] = 0;
                for (j = 0; j < SHELL_FRAME; j++) {
                    int q = pulses[i * SHELL_FRAME + j];
                    if (q > 0)
                        pulses[i * SHELL_FRAME + j] =
                            q * (2 * ec_dec_icdf(dec, icdf, 8) - 1);
                }
            }
        }
    }
}

/* ---------------- pitch lags ---------------- */

static void decode_pitch(int lag_index, int contour_index, int fs_khz,
                         int nb_subfr, int *pitchL)
{
    const int32_t *cb;
    int ncols, k, min_lag, max_lag, lag;
    if (fs_khz == 8) {
        if (nb_subfr == MAX_NB_SUBFR) { cb = T32[T32_LAGS2]; ncols = 11; }
        else { cb = T32[T32_LAGS2_10]; ncols = 3; }
    }
    else {
        if (nb_subfr == MAX_NB_SUBFR) { cb = T32[T32_LAGS3]; ncols = 34; }
        else { cb = T32[T32_LAGS3_10]; ncols = 12; }
    }
    min_lag = PITCH_EST_MIN_LAG_MS * fs_khz;
    max_lag = PITCH_EST_MAX_LAG_MS * fs_khz;
    lag = min_lag + lag_index;
    for (k = 0; k < nb_subfr; k++)
        pitchL[k] = (int)LIMIT(lag + cb[k * ncols + contour_index],
                               min_lag, max_lag);
}

/* ---------------- resampler -------------------- */

typedef struct {
    int fs_in_khz, fs_out_khz, input_delay, batch_size, mode;
    int64_t inv_ratio_q16;
    int32_t delay_buf[48];
    int64_t sIIR[6];
    int64_t sFIR[8];
} resampler;

/* mode: 0 copy, 1 up2hq, 2 iir_fir */

static int rate_id(int hz) {
    switch (hz) {
    case 8000: return 0;
    case 12000: return 1;
    case 16000: return 2;
    case 24000: return 3;
    default: return 4;
    }
}

static void resampler_init(resampler *r, int fs_in_hz, int fs_out_hz)
{
    int up2x = 0;
    memset(r, 0, sizeof(*r));
    r->fs_in_khz = fs_in_hz / 1000;
    r->fs_out_khz = fs_out_hz / 1000;
    r->input_delay =
        DELAY_MATRIX_DEC[rate_id(fs_in_hz)][rate_id(fs_out_hz)];
    r->batch_size = r->fs_in_khz * 10;
    r->mode = 0;
    if (fs_out_hz > fs_in_hz) {
        if (fs_out_hz == 2 * fs_in_hz) r->mode = 1;
        else { r->mode = 2; up2x = 1; }
    }
    r->inv_ratio_q16 =
        (((int64_t)fs_in_hz << (14 + up2x)) / fs_out_hz) << 2;
    while (SMULWW(r->inv_ratio_q16, fs_out_hz)
           < ((int64_t)fs_in_hz << up2x))
        r->inv_ratio_q16++;
}

/* 2x upsample, high quality (resampler_private_up2_HQ.c) */
static void up2_hq(resampler *r, const int32_t *x, int n, int32_t *out)
{
    const int32_t *hq0 = T32[T32_HQ0], *hq1 = T32[T32_HQ1];
    int64_t *S = r->sIIR;
    int k;
    for (k = 0; k < n; k++) {
        int64_t in32 = (int64_t)x[k] << 10;
        int64_t Y, X, o1, o2, o1f;
        Y = in32 - S[0];
        X = SMULWB(Y, hq0[0]);
        o1 = S[0] + X;
        S[0] = in32 + X;
        Y = o1 - S[1];
        X = SMULWB(Y, hq0[1]);
        o2 = S[1] + X;
        S[1] = o1 + X;
        Y = o2 - S[2];
        X = SMLAWB(Y, Y, hq0[2]);
        o1f = S[2] + X;
        S[2] = o2 + X;
        out[2 * k] = (int32_t)SAT16(RSHIFT_ROUND(o1f, 10));
        Y = in32 - S[3];
        X = SMULWB(Y, hq1[0]);
        o1 = S[3] + X;
        S[3] = in32 + X;
        Y = o1 - S[4];
        X = SMULWB(Y, hq1[1]);
        o2 = S[4] + X;
        S[4] = o1 + X;
        Y = o2 - S[5];
        X = SMLAWB(Y, Y, hq1[2]);
        o1f = S[5] + X;
        S[5] = o2 + X;
        out[2 * k + 1] = (int32_t)SAT16(RSHIFT_ROUND(o1f, 10));
    }
}

/* IIR/FIR fractional interpolation (resampler_private_IIR_FIR.c);
   returns number of output samples */
static int iir_fir(resampler *r, const int32_t *x, int n, int32_t *out)
{
    const int32_t *ff = T32[T32_FIR12];   /* [12][4] */
    int64_t buf[8 + 2 * 160 + 8];
    int nout = 0, pos = 0, n_in = 0, j;
    int64_t inc = r->inv_ratio_q16;
    for (j = 0; j < 8; j++) buf[j] = r->sFIR[j];
    for (;;) {
        int32_t up[2 * 160];
        int64_t max_index_q16, index_q16;
        n_in = n - pos < r->batch_size ? n - pos : r->batch_size;
        up2_hq(r, x + pos, n_in, up);
        for (j = 0; j < 2 * n_in; j++) buf[8 + j] = up[j];
        max_index_q16 = (int64_t)n_in << 17;
        index_q16 = 0;
        while (index_q16 < max_index_q16) {
            int table_index = (int)SMULWB(index_q16 & 0xFFFF, 12);
            int b = (int)(index_q16 >> 16);
            int64_t res;
            res = buf[b] * (int64_t)ff[table_index * 4 + 0];
            res += buf[b + 1] * (int64_t)ff[table_index * 4 + 1];
            res += buf[b + 2] * (int64_t)ff[table_index * 4 + 2];
            res += buf[b + 3] * (int64_t)ff[table_index * 4 + 3];
            res += buf[b + 4] * (int64_t)ff[(11 - table_index) * 4 + 3];
            res += buf[b + 5] * (int64_t)ff[(11 - table_index) * 4 + 2];
            res += buf[b + 6] * (int64_t)ff[(11 - table_index) * 4 + 1];
            res += buf[b + 7] * (int64_t)ff[(11 - table_index) * 4 + 0];
            out[nout++] = (int32_t)SAT16(RSHIFT_ROUND(res, 15));
            index_q16 += inc;
        }
        pos += n_in;
        if (pos >= n) break;
        for (j = 0; j < 8; j++) buf[j] = buf[n_in * 2 + j];
    }
    for (j = 0; j < 8; j++) r->sFIR[j] = buf[n_in * 2 + j];
    return nout;
}

/* silk_resampler's 1 ms delay buffering (resampler.c); returns number
   of output samples written */
static int resampler_process(resampler *r, const int32_t *x, int n,
                             int32_t *out)
{
    int fs_in = r->fs_in_khz;
    int n_samples = fs_in - r->input_delay;
    int32_t first[48 + 16];
    int nfirst = r->input_delay + n_samples;
    const int32_t *rest = x + n_samples;
    int nrest = n - fs_in;
    int nout = 0, j;
    for (j = 0; j < r->input_delay; j++) first[j] = r->delay_buf[j];
    for (j = 0; j < n_samples; j++)
        first[r->input_delay + j] = x[j];
    if (r->mode == 0) {
        for (j = 0; j < nfirst; j++) out[nout++] = first[j];
        for (j = 0; j < nrest; j++) out[nout++] = rest[j];
    }
    else if (r->mode == 1) {
        up2_hq(r, first, nfirst, out + nout);
        nout += 2 * nfirst;
        up2_hq(r, rest, nrest, out + nout);
        nout += 2 * nrest;
    }
    else {
        nout += iir_fir(r, first, nfirst, out + nout);
        nout += iir_fir(r, rest, nrest, out + nout);
    }
    for (j = 0; j < r->input_delay; j++)
        r->delay_buf[j] = x[n - r->input_delay + j];
    return nout;
}

/* ---------------- channel state ------------- */

typedef struct {
    int signalType, quantOffsetType;
    int GainsIndices[4];
    int NLSFIndices[17];
    int NLSFInterpCoef_Q2;
    int lagIndex, contourIndex, PERIndex;
    int LTPIndex[4];
    int LTP_scaleIndex, Seed;
} indices_t;

#define OUTBUF_LEN (960 + 2 * 80)

typedef struct {
    int nFramesDecoded, nFramesPerPacket, nb_subfr;
    int fs_kHz, fs_API_hz, frame_length, subfr_length;
    int ltp_mem_length, LPC_order;
    const nlsf_cb *cb;
    const uint8_t *pitch_contour_icdf, *pitch_lag_low_bits_icdf;
    int VAD_flags[3], LBRR_flag, LBRR_flags[3];
    indices_t ind;
    int64_t prevNLSF_Q15[MAX_LPC_ORDER];
    int LastGainIndex;
    int64_t prev_gain_Q16;
    int first_frame_after_reset, lagPrev;
    int ec_prevSignalType, ec_prevLagIndex;
    int prevSignalType;
    int64_t outBuf[OUTBUF_LEN];
    int64_t sLPC_Q14_buf[MAX_LPC_ORDER];
    resampler rs;
    int rs_valid;
    /* --- packet-loss concealment state (silk/PLC.h silk_PLC_struct,
       CNG.c silk_CNG_struct) --- */
    int lossCnt;
    int64_t exc_Q14_buf[MAX_FRAME_LENGTH];
    struct {
        int64_t pitchL_Q8;
        int64_t LTPCoef_Q14[LTP_ORDER];      /* int16 semantics */
        int64_t prevLPC_Q12[MAX_LPC_ORDER];  /* int16 semantics */
        int last_frame_lost;
        int64_t rand_seed, randScale_Q14;
        int64_t conc_energy;
        int conc_energy_shift;
        int64_t prevLTP_scale_Q14;
        int64_t prevGain_Q16[2];
        int fs_kHz, nb_subfr, subfr_length;
    } plc;
    struct {
        int64_t exc_buf_Q14[MAX_FRAME_LENGTH];
        int64_t smth_NLSF_Q15[MAX_LPC_ORDER];
        int64_t synth_state[MAX_LPC_ORDER];
        int64_t smth_Gain_Q16;
        int64_t rand_seed;
        int fs_kHz;
    } cng;
} chan_state;

typedef struct {
    int nChannelsAPI, nChannelsInternal, prev_decode_only_middle;
    chan_state ch[2];
    int64_t stereo_pred_prev[2];
    int64_t sMid[2], sSide[2];
} silk_state;

static void chan_init(chan_state *st)
{
    memset(st, 0, sizeof(*st));
    st->ind.NLSFInterpCoef_Q2 = 4;
    st->LastGainIndex = 10;
    st->prev_gain_Q16 = (int64_t)1 << 16;
    st->first_frame_after_reset = 1;
    st->lagPrev = 100;
    st->prevSignalType = TYPE_NO_VOICE_ACTIVITY;
}

static void chan_set_fs(chan_state *st, int fs_khz, int fs_api_hz)
{
    int frame_length;
    st->subfr_length = SUB_FRAME_LENGTH_MS * fs_khz;
    frame_length = st->nb_subfr * st->subfr_length;
    if (st->fs_kHz != fs_khz || st->fs_API_hz != fs_api_hz) {
        resampler_init(&st->rs, fs_khz * 1000, fs_api_hz);
        st->rs_valid = 1;
        st->fs_API_hz = fs_api_hz;
    }
    if (st->fs_kHz != fs_khz || frame_length != st->frame_length) {
        if (fs_khz == 8) {
            st->pitch_contour_icdf = st->nb_subfr == MAX_NB_SUBFR
                ? TU8[TU8_PC_NB] : TU8[TU8_PC10_NB];
        }
        else {
            st->pitch_contour_icdf = st->nb_subfr == MAX_NB_SUBFR
                ? TU8[TU8_PC] : TU8[TU8_PC10];
        }
        if (st->fs_kHz != fs_khz) {
            st->ltp_mem_length = LTP_MEM_LENGTH_MS * fs_khz;
            if (fs_khz == 8 || fs_khz == 12) {
                st->LPC_order = MIN_LPC_ORDER;
                st->cb = &CB_NBMB;
            }
            else {
                st->LPC_order = MAX_LPC_ORDER;
                st->cb = &CB_WB;
            }
            if (fs_khz == 16)
                st->pitch_lag_low_bits_icdf = TU8[TU8_U8];
            else if (fs_khz == 12)
                st->pitch_lag_low_bits_icdf = TU8[TU8_U6];
            else
                st->pitch_lag_low_bits_icdf = TU8[TU8_U4];
            st->first_frame_after_reset = 1;
            st->lagPrev = 100;
            st->LastGainIndex = 10;
            st->prevSignalType = TYPE_NO_VOICE_ACTIVITY;
            memset(st->outBuf, 0, sizeof(st->outBuf));
            memset(st->sLPC_Q14_buf, 0, sizeof(st->sLPC_Q14_buf));
        }
        st->fs_kHz = fs_khz;
        st->frame_length = frame_length;
    }
}

/* ---------------- indices ----------------- */

static void decode_indices(chan_state *st, ecdec *dec, int frame_index,
                           int decode_lbrr, int cond_coding)
{
    indices_t *ind = &st->ind;
    int ix, i;
    memset(ind, 0, sizeof(*ind));
    ind->NLSFInterpCoef_Q2 = 4;
    if (decode_lbrr || st->VAD_flags[frame_index])
        ix = ec_dec_icdf(dec, TU8[TU8_TYPE_VAD], 8) + 2;
    else
        ix = ec_dec_icdf(dec, TU8[TU8_TYPE_NOVAD], 8);
    ind->signalType = ix >> 1;
    ind->quantOffsetType = ix & 1;

    if (cond_coding == CODE_CONDITIONALLY) {
        ind->GainsIndices[0] = ec_dec_icdf(dec, TU8[TU8_DELTA_GAIN], 8);
    }
    else {
        ind->GainsIndices[0] = ec_dec_icdf(
            dec, TU8[TU8_GAIN] + ind->signalType * 8, 8) << 3;
        ind->GainsIndices[0] += ec_dec_icdf(dec, TU8[TU8_U8], 8);
    }
    for (i = 1; i < st->nb_subfr; i++)
        ind->GainsIndices[i] = ec_dec_icdf(dec, TU8[TU8_DELTA_GAIN], 8);

    {
        const nlsf_cb *cb = st->cb;
        int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
        ind->NLSFIndices[0] = ec_dec_icdf(
            dec, cb->CB1_iCDF + (ind->signalType >> 1) * cb->nVectors, 8);
        nlsf_unpack(cb, ind->NLSFIndices[0], ec_ix, pred_q8);
        for (i = 0; i < cb->order; i++) {
            ix = ec_dec_icdf(dec, cb->ec_iCDF + ec_ix[i], 8);
            if (ix == 0)
                ix -= ec_dec_icdf(dec, TU8[TU8_NLSF_EXT], 8);
            else if (ix == 2 * NLSF_QUANT_MAX_AMPLITUDE)
                ix += ec_dec_icdf(dec, TU8[TU8_NLSF_EXT], 8);
            ind->NLSFIndices[i + 1] = ix - NLSF_QUANT_MAX_AMPLITUDE;
        }
    }

    if (st->nb_subfr == MAX_NB_SUBFR)
        ind->NLSFInterpCoef_Q2 = ec_dec_icdf(dec, TU8[TU8_NLSF_INTERP], 8);
    else
        ind->NLSFInterpCoef_Q2 = 4;

    if (ind->signalType == TYPE_VOICED) {
        int decode_absolute = 1, k;
        if (cond_coding == CODE_CONDITIONALLY
            && st->ec_prevSignalType == TYPE_VOICED) {
            int delta = ec_dec_icdf(dec, TU8[TU8_PITCH_DELTA], 8);
            if (delta > 0) {
                ind->lagIndex = st->ec_prevLagIndex + (delta - 9);
                decode_absolute = 0;
            }
        }
        if (decode_absolute) {
            ind->lagIndex = ec_dec_icdf(dec, TU8[TU8_PITCH_LAG], 8)
                * (st->fs_kHz >> 1);
            ind->lagIndex +=
                ec_dec_icdf(dec, st->pitch_lag_low_bits_icdf, 8);
        }
        st->ec_prevLagIndex = ind->lagIndex;
        ind->contourIndex = ec_dec_icdf(dec, st->pitch_contour_icdf, 8);
        ind->PERIndex = ec_dec_icdf(dec, TU8[TU8_LTP_PER], 8);
        for (k = 0; k < st->nb_subfr; k++)
            ind->LTPIndex[k] = ec_dec_icdf(
                dec, TU8[TU8_LTP_G0 + ind->PERIndex], 8);
        if (cond_coding == CODE_INDEPENDENTLY)
            ind->LTP_scaleIndex = ec_dec_icdf(dec, TU8[TU8_LTPSCALE], 8);
        else
            ind->LTP_scaleIndex = 0;
    }
    st->ec_prevSignalType = ind->signalType;
    ind->Seed = ec_dec_icdf(dec, TU8[TU8_U4], 8);
}

/* ---------------- parameters ----------- */

typedef struct {
    int64_t gains[4];
    int64_t pred0[MAX_LPC_ORDER], pred1[MAX_LPC_ORDER];
    int pitchL[4];
    int64_t ltp_coef[LTP_ORDER * 4];
    int64_t ltp_scale;
} frame_params;

/* bwexpander.c (int16 AR coefs; silk_MUL + RSHIFT_ROUND, not SMULWB) */
static void bwexpander_16(int64_t *ar, int d, int64_t chirp_q16)
{
    int i;
    int64_t chirp_minus_one_q16 = chirp_q16 - 65536;
    for (i = 0; i < d - 1; i++) {
        ar[i] = I16(RSHIFT_ROUND(chirp_q16 * ar[i], 16));
        chirp_q16 += RSHIFT_ROUND(chirp_q16 * chirp_minus_one_q16, 16);
    }
    ar[d - 1] = I16(RSHIFT_ROUND(chirp_q16 * ar[d - 1], 16));
}

static void decode_parameters(chan_state *st, int cond_coding,
                              frame_params *p)
{
    indices_t *ind = &st->ind;
    int64_t nlsf[MAX_LPC_ORDER];
    int i, k;
    gains_dequant(ind->GainsIndices, &st->LastGainIndex,
                  cond_coding == CODE_CONDITIONALLY, st->nb_subfr,
                  p->gains);
    nlsf_decode(ind->NLSFIndices, st->cb, nlsf);
    nlsf2a(nlsf, st->LPC_order, p->pred1);
    if (st->first_frame_after_reset) ind->NLSFInterpCoef_Q2 = 4;
    if (ind->NLSFInterpCoef_Q2 < 4) {
        int64_t nlsf0[MAX_LPC_ORDER];
        for (i = 0; i < st->LPC_order; i++)
            nlsf0[i] = st->prevNLSF_Q15[i]
                + ((ind->NLSFInterpCoef_Q2
                    * (nlsf[i] - st->prevNLSF_Q15[i])) >> 2);
        nlsf2a(nlsf0, st->LPC_order, p->pred0);
    }
    else {
        memcpy(p->pred0, p->pred1, sizeof(p->pred1));
    }
    for (i = 0; i < st->LPC_order; i++) st->prevNLSF_Q15[i] = nlsf[i];

    /* After a packet loss do BWE of LPC coefs
       (decode_parameters.c:81, BWE_AFTER_LOSS_Q16 = 63570 = 0.97) */
    if (st->lossCnt) {
        bwexpander_16(p->pred0, st->LPC_order, 63570);
        bwexpander_16(p->pred1, st->LPC_order, 63570);
    }

    memset(p->pitchL, 0, sizeof(p->pitchL));
    memset(p->ltp_coef, 0, sizeof(p->ltp_coef));
    p->ltp_scale = 0;
    if (ind->signalType == TYPE_VOICED) {
        const int32_t *cbk = T32[T32_VQ0 + ind->PERIndex];
        decode_pitch(ind->lagIndex, ind->contourIndex, st->fs_kHz,
                     st->nb_subfr, p->pitchL);
        for (k = 0; k < st->nb_subfr; k++)
            for (i = 0; i < LTP_ORDER; i++)
                p->ltp_coef[k * LTP_ORDER + i] =
                    (int64_t)cbk[ind->LTPIndex[k] * LTP_ORDER + i] << 7;
        p->ltp_scale = T32[T32_LTPSCALES][ind->LTP_scaleIndex];
    }
}

/* ---------------- core ----------------------- */

static void lpc_analysis_filter(const int64_t *x, const int64_t *B,
                                int length, int d, int64_t *out)
{
    int ix, j;
    for (ix = 0; ix < d; ix++) out[ix] = 0;
    for (ix = d; ix < length; ix++) {
        int64_t s = SMULBB(x[ix - 1], B[0]);
        int64_t v;
        for (j = 1; j < d; j++)
            s = I32(s + SMULBB(x[ix - 1 - j], B[j]));
        v = I32((x[ix] << 12) - s);
        out[ix] = SAT16(RSHIFT_ROUND(v, 12));
    }
}

static void decode_core(chan_state *st, frame_params *p,
                        const int *pulses, int64_t *xq)
{
    indices_t *ind = &st->ind;
    int offset_q10 = T32[T32_QOFF][(ind->signalType >> 1) * 2
                                   + ind->quantOffsetType];
    int nlsf_interp_flag = ind->NLSFInterpCoef_Q2 < 4 ? 1 : 0;
    int64_t rand_seed = ind->Seed;
    int64_t exc_q14[MAX_FRAME_LENGTH];
    int64_t sLPC[MAX_LPC_ORDER + 80];   /* subfr_length <= 80 */
    int64_t sLTP[320];
    int64_t sLTP_Q15[320 + MAX_FRAME_LENGTH];
    int sLTP_buf_idx = st->ltp_mem_length;
    int lag = 0, i, j, k;

    for (i = 0; i < st->frame_length; i++) {
        int64_t v;
        rand_seed = silk_rand(rand_seed);
        v = (int64_t)pulses[i] << 14;
        if (v > 0) v -= QUANT_LEVEL_ADJUST_Q10 << 4;
        else if (v < 0) v += QUANT_LEVEL_ADJUST_Q10 << 4;
        v += (int64_t)offset_q10 << 4;
        if (rand_seed < 0) v = -v;
        exc_q14[i] = v;
        st->exc_Q14_buf[i] = v;   /* persisted for PLC/CNG (decode_core.c
                                     psDec->exc_Q14) */
        rand_seed = I32(rand_seed + pulses[i]);
    }

    memcpy(sLPC, st->sLPC_Q14_buf, sizeof(st->sLPC_Q14_buf));
    memset(sLPC + MAX_LPC_ORDER, 0,
           sizeof(int64_t) * (size_t)st->subfr_length);
    memset(sLTP, 0, sizeof(sLTP));
    memset(sLTP_Q15, 0, sizeof(sLTP_Q15));

    for (k = 0; k < st->nb_subfr; k++) {
        const int64_t *A_Q12 = (k >> 1) == 0 ? p->pred0 : p->pred1;
        int64_t *B_Q14 = p->ltp_coef + k * LTP_ORDER;
        int signal_type = ind->signalType;

        /* Avoid abrupt transition from voiced PLC to unvoiced normal
           decoding (decode_core.c:125-133); the LTPCoef/pitchL
           mutations are visible to the later PLC state update, as in
           the reference. */
        if (st->lossCnt && st->prevSignalType == TYPE_VOICED
            && ind->signalType != TYPE_VOICED && k < MAX_NB_SUBFR / 2) {
            memset(B_Q14, 0, LTP_ORDER * sizeof(int64_t));
            B_Q14[LTP_ORDER / 2] = 4096;   /* 0.25 in Q14 */
            signal_type = TYPE_VOICED;
            p->pitchL[k] = st->lagPrev;
        }
        int64_t gain_q10 = p->gains[k] >> 6;
        int64_t inv_gain_q31 = inverse32_varq(p->gains[k], 47);
        int64_t gain_adj_q16;
        int64_t res_q14[80];
        int d = st->LPC_order;

        if (p->gains[k] != st->prev_gain_Q16) {
            gain_adj_q16 = div32_varq(st->prev_gain_Q16, p->gains[k], 16);
            for (i = 0; i < MAX_LPC_ORDER; i++)
                sLPC[i] = SMULWW(gain_adj_q16, sLPC[i]);
        }
        else gain_adj_q16 = (int64_t)1 << 16;
        st->prev_gain_Q16 = p->gains[k];

        if (signal_type == TYPE_VOICED) {
            lag = p->pitchL[k];
            if (k == 0 || (k == 2 && nlsf_interp_flag)) {
                int start_idx = st->ltp_mem_length - lag
                    - st->LPC_order - LTP_ORDER / 2;
                int64_t filt[320];
                if (k == 2) {
                    for (i = 0; i < 2 * st->subfr_length; i++)
                        st->outBuf[st->ltp_mem_length + i] = xq[i];
                }
                lpc_analysis_filter(
                    st->outBuf + start_idx + k * st->subfr_length,
                    A_Q12, st->ltp_mem_length - start_idx,
                    st->LPC_order, filt);
                for (i = 0; i < st->ltp_mem_length - start_idx; i++)
                    sLTP[start_idx + i] = filt[i];
                if (k == 0)
                    inv_gain_q31 = I32(
                        SMULWB(inv_gain_q31, p->ltp_scale) << 2);
                for (i = 0; i < lag + LTP_ORDER / 2; i++)
                    sLTP_Q15[sLTP_buf_idx - i - 1] = SMULWB(
                        inv_gain_q31, sLTP[st->ltp_mem_length - i - 1]);
            }
            else {
                if (gain_adj_q16 != (int64_t)1 << 16) {
                    for (i = 0; i < lag + LTP_ORDER / 2; i++)
                        sLTP_Q15[sLTP_buf_idx - i - 1] = SMULWW(
                            gain_adj_q16, sLTP_Q15[sLTP_buf_idx - i - 1]);
                }
            }
        }

        if (signal_type == TYPE_VOICED) {
            int pred_base = sLTP_buf_idx - lag + LTP_ORDER / 2;
            for (i = 0; i < st->subfr_length; i++) {
                int pp = pred_base + i;
                int64_t ltp_pred = 2, res;
                ltp_pred = I32(SMLAWB(ltp_pred, sLTP_Q15[pp], B_Q14[0]));
                ltp_pred = I32(SMLAWB(ltp_pred, sLTP_Q15[pp - 1],
                                      B_Q14[1]));
                ltp_pred = I32(SMLAWB(ltp_pred, sLTP_Q15[pp - 2],
                                      B_Q14[2]));
                ltp_pred = I32(SMLAWB(ltp_pred, sLTP_Q15[pp - 3],
                                      B_Q14[3]));
                ltp_pred = I32(SMLAWB(ltp_pred, sLTP_Q15[pp - 4],
                                      B_Q14[4]));
                res = I32(exc_q14[k * st->subfr_length + i]
                          + I32(ltp_pred << 1));
                res_q14[i] = res;
                sLTP_Q15[sLTP_buf_idx] = I32(res << 1);
                sLTP_buf_idx++;
            }
        }
        else {
            for (i = 0; i < st->subfr_length; i++)
                res_q14[i] = exc_q14[k * st->subfr_length + i];
        }

        for (i = 0; i < st->subfr_length; i++) {
            int pos = MAX_LPC_ORDER + i;
            int64_t lpc_pred = d >> 1, v;
            for (j = 0; j < d; j++)
                lpc_pred = I32(SMLAWB(lpc_pred, sLPC[pos - 1 - j],
                                      A_Q12[j]));
            v = I32(res_q14[i] + I32(I32(lpc_pred) << 4));
            sLPC[pos] = v;
            xq[k * st->subfr_length + i] =
                SAT16(RSHIFT_ROUND(SMULWW(v, gain_q10), 8));
        }
        /* shift state: sLPC = sLPC[subfr:subfr+16] + zeros */
        memmove(sLPC, sLPC + st->subfr_length,
                sizeof(int64_t) * MAX_LPC_ORDER);
        memset(sLPC + MAX_LPC_ORDER, 0,
               sizeof(int64_t) * (size_t)st->subfr_length);
    }
    memcpy(st->sLPC_Q14_buf, sLPC, sizeof(st->sLPC_Q14_buf));
}

/* ============== packet-loss concealment + comfort noise ==============
 * Port of the reference's silk/PLC.c (silk_PLC_update :95, _conceal
 * :168, _glue_frames :367) and silk/CNG.c (silk_CNG :80, _exc :36) in
 * this file's int64/I32 idiom; bit-exact against the reference
 * decoder's own opus_decode(NULL) output (tests/golden/opus_plc.bin).
 * silk_PLC(update) + silk_CNG run on EVERY normal frame, so the state
 * they read (exc_Q14_buf, prev LPC/LTP/gains/pitch) is persisted by
 * decode_core/decode_parameters above. */

#define NB_ATT 2
#define RAND_BUF_SIZE 128
#define RAND_BUF_MASK (RAND_BUF_SIZE - 1)
#define V_PITCH_GAIN_START_MIN_Q14 11469
#define V_PITCH_GAIN_START_MAX_Q14 15565
#define MAX_PITCH_LAG_MS_PLC 18
#define LOG2_INV_LPC_GAIN_HIGH_THRES 3
#define LOG2_INV_LPC_GAIN_LOW_THRES 8
#define PITCH_DRIFT_FAC_Q16 655
#define BWE_COEF_Q16 ((int64_t)(0.99 * 65536.0 + 0.5))
#define CNG_BUF_MASK_MAX 255
#define CNG_GAIN_SMTH_Q16 4634
#define CNG_NLSF_SMTH_Q16 16348
#define CNG_RAND_SEED 3176576

static const int64_t HARM_ATT_Q15[NB_ATT] = {32440, 31130};
static const int64_t PLC_RAND_ATT_V_Q15[NB_ATT] = {31130, 26214};
static const int64_t PLC_RAND_ATT_UV_Q15[NB_ATT] = {32440, 29491};

/* sum_sqr_shift.c (int16 inputs; uint32 wrap semantics preserved) */
static void sum_sqr_shift(int64_t *energy, int *shift, const int64_t *x,
                          int len)
{
    int i, shft = 0;
    int64_t nrg = 0, nrg_tmp;
    len--;
    for (i = 0; i < len; i += 2) {
        nrg = I32(nrg + I32(SMULBB(x[i], x[i])));
        nrg = I32(nrg + I32(SMULBB(x[i + 1], x[i + 1])));
        if (nrg < 0) {
            nrg = (int64_t)((uint32_t)(uint64_t)nrg >> 2);
            shft = 2;
            break;
        }
    }
    for (; i < len; i += 2) {
        nrg_tmp = SMULBB(x[i], x[i]);
        nrg_tmp = I32(nrg_tmp + I32(SMULBB(x[i + 1], x[i + 1])));
        nrg = I32((uint32_t)(uint64_t)nrg
                  + ((uint32_t)(uint64_t)nrg_tmp >> shft));
        if (nrg < 0) {
            nrg = (int64_t)((uint32_t)(uint64_t)nrg >> 2);
            shft += 2;
        }
    }
    if (i == len) {
        nrg_tmp = SMULBB(x[i], x[i]);
        nrg = I32((uint32_t)(uint64_t)nrg
                  + ((uint32_t)(uint64_t)nrg_tmp >> shft));
    }
    if (nrg & 0xC0000000) {
        nrg = (int64_t)((uint32_t)(uint64_t)nrg >> 2);
        shft += 2;
    }
    *energy = nrg;
    *shift = shft;
}

static void plc_reset(chan_state *st)
{
    st->plc.pitchL_Q8 = (int64_t)st->frame_length << 7;
    st->plc.prevGain_Q16[0] = (int64_t)1 << 16;
    st->plc.prevGain_Q16[1] = (int64_t)1 << 16;
    st->plc.subfr_length = 20;
    st->plc.nb_subfr = 2;
}

/* PLC.c:95 silk_PLC_update */
static void plc_update(chan_state *st, const frame_params *p)
{
    int64_t LTP_Gain_Q14 = 0, temp;
    int i, j;
    st->prevSignalType = st->ind.signalType;
    if (st->ind.signalType == TYPE_VOICED) {
        for (j = 0; j * st->subfr_length < p->pitchL[st->nb_subfr - 1];
             j++) {
            if (j == st->nb_subfr) break;
            temp = 0;
            for (i = 0; i < LTP_ORDER; i++)
                temp += p->ltp_coef[(st->nb_subfr - 1 - j) * LTP_ORDER
                                    + i];
            if (temp > LTP_Gain_Q14) {
                LTP_Gain_Q14 = temp;
                for (i = 0; i < LTP_ORDER; i++)
                    st->plc.LTPCoef_Q14[i] = p->ltp_coef[
                        (st->nb_subfr - 1 - j) * LTP_ORDER + i];
                st->plc.pitchL_Q8 =
                    (int64_t)p->pitchL[st->nb_subfr - 1 - j] << 8;
            }
        }
        memset(st->plc.LTPCoef_Q14, 0, sizeof(st->plc.LTPCoef_Q14));
        st->plc.LTPCoef_Q14[LTP_ORDER / 2] = I16(LTP_Gain_Q14);

        if (LTP_Gain_Q14 < V_PITCH_GAIN_START_MIN_Q14) {
            int64_t scale_q10 = CDIV(
                (int64_t)V_PITCH_GAIN_START_MIN_Q14 << 10,
                LTP_Gain_Q14 > 1 ? LTP_Gain_Q14 : 1);
            for (i = 0; i < LTP_ORDER; i++)
                st->plc.LTPCoef_Q14[i] = I16(
                    SMULBB(st->plc.LTPCoef_Q14[i], scale_q10) >> 10);
        }
        else if (LTP_Gain_Q14 > V_PITCH_GAIN_START_MAX_Q14) {
            int64_t scale_q14 = CDIV(
                (int64_t)V_PITCH_GAIN_START_MAX_Q14 << 14,
                LTP_Gain_Q14 > 1 ? LTP_Gain_Q14 : 1);
            for (i = 0; i < LTP_ORDER; i++)
                st->plc.LTPCoef_Q14[i] = I16(
                    SMULBB(st->plc.LTPCoef_Q14[i], scale_q14) >> 14);
        }
    }
    else {
        st->plc.pitchL_Q8 = (int64_t)(st->fs_kHz * 18) << 8;
        memset(st->plc.LTPCoef_Q14, 0, sizeof(st->plc.LTPCoef_Q14));
    }
    for (i = 0; i < st->LPC_order; i++)
        st->plc.prevLPC_Q12[i] = p->pred1[i];
    st->plc.prevLTP_scale_Q14 = p->ltp_scale;
    st->plc.prevGain_Q16[0] = p->gains[st->nb_subfr - 2];
    st->plc.prevGain_Q16[1] = p->gains[st->nb_subfr - 1];
    st->plc.subfr_length = st->subfr_length;
    st->plc.nb_subfr = st->nb_subfr;
}

/* PLC.c:168 silk_PLC_conceal */
static void plc_conceal(chan_state *st, frame_params *p, int64_t *frame)
{
    int i, j, k, lag, idx, sLTP_buf_idx;
    int shift1, shift2;
    int64_t energy1, energy2;
    int64_t rand_seed, harm_Gain_Q15, rand_Gain_Q15, inv_gain_Q30;
    int64_t rand_scale_Q14;
    int64_t LPC_pred_Q10, LTP_pred_Q12;
    int64_t exc_buf[2 * 80];
    int64_t A_Q12[MAX_LPC_ORDER];
    int64_t sLTP[320];
    int64_t sLTP_Q14[320 + MAX_FRAME_LENGTH];
    int64_t filt[320];
    const int64_t *rand_ptr;
    int64_t *B_Q14 = st->plc.LTPCoef_Q14;
    int64_t prevGain_Q10[2];

    prevGain_Q10[0] = st->plc.prevGain_Q16[0] >> 6;
    prevGain_Q10[1] = st->plc.prevGain_Q16[1] >> 6;

    if (st->first_frame_after_reset)
        memset(st->plc.prevLPC_Q12, 0, sizeof(st->plc.prevLPC_Q12));

    /* scale the last two subframes of excitation */
    for (k = 0; k < 2; k++)
        for (i = 0; i < st->plc.subfr_length; i++)
            exc_buf[k * st->plc.subfr_length + i] = SAT16(
                SMULWW(st->exc_Q14_buf[
                           i + (k + st->plc.nb_subfr - 2)
                               * st->plc.subfr_length],
                       prevGain_Q10[k]) >> 8);
    sum_sqr_shift(&energy1, &shift1, exc_buf, st->plc.subfr_length);
    sum_sqr_shift(&energy2, &shift2, exc_buf + st->plc.subfr_length,
                  st->plc.subfr_length);

    if ((energy1 >> shift2) < (energy2 >> shift1)) {
        idx = (st->plc.nb_subfr - 1) * st->plc.subfr_length
              - RAND_BUF_SIZE;
        rand_ptr = st->exc_Q14_buf + (idx > 0 ? idx : 0);
    }
    else {
        idx = st->plc.nb_subfr * st->plc.subfr_length - RAND_BUF_SIZE;
        rand_ptr = st->exc_Q14_buf + (idx > 0 ? idx : 0);
    }

    rand_scale_Q14 = st->plc.randScale_Q14;
    harm_Gain_Q15 = HARM_ATT_Q15[st->lossCnt < NB_ATT - 1
                                 ? st->lossCnt : NB_ATT - 1];
    if (st->prevSignalType == TYPE_VOICED)
        rand_Gain_Q15 = PLC_RAND_ATT_V_Q15[
            st->lossCnt < NB_ATT - 1 ? st->lossCnt : NB_ATT - 1];
    else
        rand_Gain_Q15 = PLC_RAND_ATT_UV_Q15[
            st->lossCnt < NB_ATT - 1 ? st->lossCnt : NB_ATT - 1];

    /* bandwidth-expand previous LPC (persists across losses) */
    bwexpander_16(st->plc.prevLPC_Q12, st->LPC_order, BWE_COEF_Q16);
    for (i = 0; i < st->LPC_order; i++)
        A_Q12[i] = st->plc.prevLPC_Q12[i];

    if (st->lossCnt == 0) {
        rand_scale_Q14 = 1 << 14;
        if (st->prevSignalType == TYPE_VOICED) {
            for (i = 0; i < LTP_ORDER; i++)
                rand_scale_Q14 -= B_Q14[i];
            if (rand_scale_Q14 < 3277) rand_scale_Q14 = 3277;
            rand_scale_Q14 = I16(
                SMULBB(rand_scale_Q14, st->plc.prevLTP_scale_Q14) >> 14);
        }
        else {
            int64_t invGain_Q30, down_scale_Q30;
            invGain_Q30 = lpc_inverse_pred_gain(st->plc.prevLPC_Q12,
                                                st->LPC_order);
            down_scale_Q30 = ((int64_t)1 << 30)
                             >> LOG2_INV_LPC_GAIN_HIGH_THRES;
            if (invGain_Q30 < down_scale_Q30)
                down_scale_Q30 = invGain_Q30;
            if (down_scale_Q30 < ((int64_t)1 << 30)
                                 >> LOG2_INV_LPC_GAIN_LOW_THRES)
                down_scale_Q30 = ((int64_t)1 << 30)
                                 >> LOG2_INV_LPC_GAIN_LOW_THRES;
            down_scale_Q30 = I32(down_scale_Q30
                                 << LOG2_INV_LPC_GAIN_HIGH_THRES);
            rand_Gain_Q15 = SMULWB(down_scale_Q30, rand_Gain_Q15) >> 14;
        }
    }

    rand_seed = st->plc.rand_seed;
    lag = (int)RSHIFT_ROUND(st->plc.pitchL_Q8, 8);
    sLTP_buf_idx = st->ltp_mem_length;

    /* rewhiten the LTP state (LPC analysis filter over outBuf) */
    idx = st->ltp_mem_length - lag - st->LPC_order - LTP_ORDER / 2;
    if (idx <= 0) idx = 1;  /* reference asserts idx > 0 */
    lpc_analysis_filter(st->outBuf + idx, A_Q12,
                        st->ltp_mem_length - idx, st->LPC_order, filt);
    memset(sLTP, 0, sizeof(sLTP));
    for (i = 0; i < st->ltp_mem_length - idx; i++)
        sLTP[idx + i] = filt[i];
    inv_gain_Q30 = inverse32_varq(st->plc.prevGain_Q16[1], 46);
    if (inv_gain_Q30 > (I32_MAX >> 1)) inv_gain_Q30 = I32_MAX >> 1;
    memset(sLTP_Q14, 0, sizeof(sLTP_Q14));
    for (i = idx + st->LPC_order; i < st->ltp_mem_length; i++)
        sLTP_Q14[i] = SMULWB(inv_gain_Q30, sLTP[i]);

    /* LTP synthesis */
    for (k = 0; k < st->nb_subfr; k++) {
        int pred_base = sLTP_buf_idx - lag + LTP_ORDER / 2;
        for (i = 0; i < st->subfr_length; i++) {
            int pp = pred_base + i;
            LTP_pred_Q12 = 2;
            LTP_pred_Q12 = I32(SMLAWB(LTP_pred_Q12, sLTP_Q14[pp],
                                      B_Q14[0]));
            LTP_pred_Q12 = I32(SMLAWB(LTP_pred_Q12, sLTP_Q14[pp - 1],
                                      B_Q14[1]));
            LTP_pred_Q12 = I32(SMLAWB(LTP_pred_Q12, sLTP_Q14[pp - 2],
                                      B_Q14[2]));
            LTP_pred_Q12 = I32(SMLAWB(LTP_pred_Q12, sLTP_Q14[pp - 3],
                                      B_Q14[3]));
            LTP_pred_Q12 = I32(SMLAWB(LTP_pred_Q12, sLTP_Q14[pp - 4],
                                      B_Q14[4]));
            rand_seed = silk_rand(rand_seed);
            j = (int)((rand_seed >> 25) & RAND_BUF_MASK);
            sLTP_Q14[sLTP_buf_idx] = I32(
                I32(SMLAWB(LTP_pred_Q12, rand_ptr[j], rand_scale_Q14))
                << 2);
            sLTP_buf_idx++;
        }
        for (j = 0; j < LTP_ORDER; j++)
            B_Q14[j] = I16(SMULBB(harm_Gain_Q15, B_Q14[j]) >> 15);
        rand_scale_Q14 = I16(
            SMULBB(rand_scale_Q14, rand_Gain_Q15) >> 15);
        st->plc.pitchL_Q8 = I32(SMLAWB(st->plc.pitchL_Q8,
                                       st->plc.pitchL_Q8,
                                       PITCH_DRIFT_FAC_Q16));
        if (st->plc.pitchL_Q8 >
            ((int64_t)(MAX_PITCH_LAG_MS_PLC * st->fs_kHz) << 8))
            st->plc.pitchL_Q8 =
                (int64_t)(MAX_PITCH_LAG_MS_PLC * st->fs_kHz) << 8;
        lag = (int)RSHIFT_ROUND(st->plc.pitchL_Q8, 8);
    }

    /* LPC synthesis */
    {
        int64_t *sLPC = sLTP_Q14 + st->ltp_mem_length - MAX_LPC_ORDER;
        memcpy(sLPC, st->sLPC_Q14_buf, sizeof(st->sLPC_Q14_buf));
        for (i = 0; i < st->frame_length; i++) {
            int pos = MAX_LPC_ORDER + i;
            LPC_pred_Q10 = st->LPC_order >> 1;
            for (j = 0; j < st->LPC_order; j++)
                LPC_pred_Q10 = I32(SMLAWB(LPC_pred_Q10,
                                          sLPC[pos - 1 - j], A_Q12[j]));
            sLPC[pos] = I32(sLPC[pos] + I32(LPC_pred_Q10 << 4));
            frame[i] = SAT16(SAT16(RSHIFT_ROUND(
                SMULWW(sLPC[pos], prevGain_Q10[1]), 8)));
        }
        memcpy(st->sLPC_Q14_buf, sLPC + st->frame_length,
               sizeof(st->sLPC_Q14_buf));
    }

    st->plc.rand_seed = rand_seed;
    st->plc.randScale_Q14 = rand_scale_Q14;
    for (i = 0; i < MAX_NB_SUBFR; i++) p->pitchL[i] = lag;
}

/* PLC.c:64 silk_PLC */
static void silk_plc(chan_state *st, frame_params *p, int64_t *frame,
                     int lost)
{
    if (st->fs_kHz != st->plc.fs_kHz) {
        plc_reset(st);
        st->plc.fs_kHz = st->fs_kHz;
    }
    if (lost) {
        plc_conceal(st, p, frame);
        st->lossCnt++;
    }
    else
        plc_update(st, p);
}

/* PLC.c:367 silk_PLC_glue_frames */
static void plc_glue(chan_state *st, int64_t *frame, int length)
{
    int i, energy_shift;
    int64_t energy;
    if (st->lossCnt) {
        sum_sqr_shift(&st->plc.conc_energy, &st->plc.conc_energy_shift,
                      frame, length);
        st->plc.last_frame_lost = 1;
    }
    else {
        if (st->plc.last_frame_lost) {
            sum_sqr_shift(&energy, &energy_shift, frame, length);
            if (energy_shift > st->plc.conc_energy_shift)
                st->plc.conc_energy >>= energy_shift
                                        - st->plc.conc_energy_shift;
            else if (energy_shift < st->plc.conc_energy_shift)
                energy >>= st->plc.conc_energy_shift - energy_shift;
            if (energy > st->plc.conc_energy) {
                int64_t frac_Q24, LZ, gain_Q16, slope_Q16;
                LZ = CLZ32(st->plc.conc_energy) - 1;
                st->plc.conc_energy = I32(st->plc.conc_energy << LZ);
                energy >>= (24 - LZ) > 0 ? 24 - LZ : 0;
                frac_Q24 = CDIV(st->plc.conc_energy,
                                energy > 1 ? energy : 1);
                gain_Q16 = I32(sqrt_approx(frac_Q24) << 4);
                slope_Q16 = CDIV(((int64_t)1 << 16) - gain_Q16, length);
                slope_Q16 = I32(slope_Q16 << 2);
                for (i = 0; i < length; i++) {
                    frame[i] = SMULWB(gain_Q16, frame[i]);
                    gain_Q16 += slope_Q16;
                    if (gain_Q16 > (int64_t)1 << 16) break;
                }
            }
        }
        st->plc.last_frame_lost = 0;
    }
}

/* CNG.c:36 silk_CNG_exc */
static void cng_exc(int64_t *residual_Q10, const int64_t *exc_buf_Q14,
                    int64_t Gain_Q16, int length, int64_t *rand_seed)
{
    int64_t seed = *rand_seed;
    int i, idx, exc_mask = CNG_BUF_MASK_MAX;
    while (exc_mask > length) exc_mask >>= 1;
    for (i = 0; i < length; i++) {
        seed = silk_rand(seed);
        idx = (int)((seed >> 24) & exc_mask);
        residual_Q10[i] = I16(SAT16(
            SMULWW(exc_buf_Q14[idx], Gain_Q16 >> 4)));
    }
    *rand_seed = seed;
}

static void cng_reset(chan_state *st)
{
    int i;
    int64_t step = CDIV(32767, st->LPC_order + 1), acc = 0;
    for (i = 0; i < st->LPC_order; i++) {
        acc += step;
        st->cng.smth_NLSF_Q15[i] = acc;
    }
    st->cng.smth_Gain_Q16 = 0;
    st->cng.rand_seed = CNG_RAND_SEED;
}

/* CNG.c:80 silk_CNG */
static void silk_cng(chan_state *st, const frame_params *p,
                     int64_t *frame, int length)
{
    int i, subfr;
    int64_t sum_Q6, max_Gain_Q16;
    int64_t A_Q12[MAX_LPC_ORDER];
    if (st->fs_kHz != st->cng.fs_kHz) {
        cng_reset(st);
        st->cng.fs_kHz = st->fs_kHz;
    }
    if (st->lossCnt == 0
        && st->prevSignalType == TYPE_NO_VOICE_ACTIVITY) {
        for (i = 0; i < st->LPC_order; i++)
            st->cng.smth_NLSF_Q15[i] += SMULWB(
                st->prevNLSF_Q15[i] - st->cng.smth_NLSF_Q15[i],
                CNG_NLSF_SMTH_Q16);
        max_Gain_Q16 = 0;
        subfr = 0;
        for (i = 0; i < st->nb_subfr; i++)
            if (p->gains[i] > max_Gain_Q16) {
                max_Gain_Q16 = p->gains[i];
                subfr = i;
            }
        memmove(st->cng.exc_buf_Q14 + st->subfr_length,
                st->cng.exc_buf_Q14,
                (size_t)((st->nb_subfr - 1) * st->subfr_length)
                    * sizeof(int64_t));
        memcpy(st->cng.exc_buf_Q14,
               st->exc_Q14_buf + subfr * st->subfr_length,
               (size_t)st->subfr_length * sizeof(int64_t));
        for (i = 0; i < st->nb_subfr; i++)
            st->cng.smth_Gain_Q16 += SMULWB(
                p->gains[i] - st->cng.smth_Gain_Q16, CNG_GAIN_SMTH_Q16);
    }
    if (st->lossCnt) {
        int64_t CNG_sig_Q10[MAX_FRAME_LENGTH + MAX_LPC_ORDER];
        cng_exc(CNG_sig_Q10 + MAX_LPC_ORDER, st->cng.exc_buf_Q14,
                st->cng.smth_Gain_Q16, length, &st->cng.rand_seed);
        nlsf2a(st->cng.smth_NLSF_Q15, st->LPC_order, A_Q12);
        memcpy(CNG_sig_Q10, st->cng.synth_state,
               MAX_LPC_ORDER * sizeof(int64_t));
        for (i = 0; i < length; i++) {
            int pos = MAX_LPC_ORDER + i;
            int j;
            sum_Q6 = st->LPC_order >> 1;
            for (j = 0; j < st->LPC_order; j++)
                sum_Q6 = I32(SMLAWB(sum_Q6, CNG_sig_Q10[pos - 1 - j],
                                    A_Q12[j]));
            CNG_sig_Q10[pos] = I32(CNG_sig_Q10[pos] + I32(sum_Q6 << 4));
            frame[i] = SAT16(frame[i] + RSHIFT_ROUND(sum_Q6, 6));
        }
        memcpy(st->cng.synth_state, CNG_sig_Q10 + length,
               MAX_LPC_ORDER * sizeof(int64_t));
    }
    else
        memset(st->cng.synth_state, 0,
               (size_t)st->LPC_order * sizeof(int64_t));
}

/* ---------------- frame --------------------- */

static void decode_frame(chan_state *st, ecdec *dec, int cond_coding,
                         int64_t *xq)
{
    /* reference decode_frame.c:39-120: normal decode + PLC state
       update + output buffering + glue + CNG */
    frame_params params;
    int pulses[MAX_ITER * SHELL_FRAME];
    int mv, i;
    decode_indices(st, dec, st->nFramesDecoded, 0, cond_coding);
    decode_pulses(dec, st->ind.signalType, st->ind.quantOffsetType,
                  st->frame_length, pulses);
    decode_parameters(st, cond_coding, &params);
    decode_core(st, &params, pulses, xq);
    silk_plc(st, &params, xq, 0);
    st->lossCnt = 0;
    st->prevSignalType = st->ind.signalType;
    st->first_frame_after_reset = 0;
    mv = st->ltp_mem_length - st->frame_length;
    for (i = 0; i < mv; i++)
        st->outBuf[i] = st->outBuf[st->frame_length + i];
    for (i = 0; i < st->frame_length; i++)
        st->outBuf[mv + i] = xq[i];
    plc_glue(st, xq, st->frame_length);
    silk_cng(st, &params, xq, st->frame_length);
    st->lagPrev = params.pitchL[st->nb_subfr - 1];
}

/* Lost-frame path (decode_frame.c:98-100 + PLC extrapolation) */
static void decode_frame_lost(chan_state *st, int64_t *xq)
{
    frame_params params;
    int mv, i;
    memset(&params, 0, sizeof(params));
    silk_plc(st, &params, xq, 1);
    mv = st->ltp_mem_length - st->frame_length;
    for (i = 0; i < mv; i++)
        st->outBuf[i] = st->outBuf[st->frame_length + i];
    for (i = 0; i < st->frame_length; i++)
        st->outBuf[mv + i] = xq[i];
    plc_glue(st, xq, st->frame_length);
    silk_cng(st, &params, xq, st->frame_length);
    st->lagPrev = params.pitchL[st->nb_subfr - 1];
}

/* ---------------- stereo ----------------------- */

static void stereo_decode_pred(ecdec *dec, int64_t *pred)
{
    int n = ec_dec_icdf(dec, TU8[TU8_STEREO_JOINT], 8);
    int ix[2][3];
    const int32_t *quant = T32[T32_STEREO_QUANT];
    int ch;
    ix[0][2] = n / 5;
    ix[1][2] = n - 5 * ix[0][2];
    for (ch = 0; ch < 2; ch++) {
        ix[ch][0] = ec_dec_icdf(dec, TU8[TU8_U3], 8);
        ix[ch][1] = ec_dec_icdf(dec, TU8[TU8_U5], 8);
    }
    for (ch = 0; ch < 2; ch++) {
        int64_t low, step;
        ix[ch][0] += 3 * ix[ch][2];
        low = quant[ix[ch][0]];
        step = SMULWB(quant[ix[ch][0] + 1] - low,
                      (int64_t)(0.5 / 5 * 65536 + 0.5));
        pred[ch] = SMLABB(low, step, 2 * ix[ch][1] + 1);
    }
    pred[0] -= pred[1];
}

typedef struct {
    int64_t pred_prev_Q13[2];
    int64_t sMid[2], sSide[2];
} stereo_io;

static void stereo_ms_to_lr(stereo_io *s, int64_t *x1, int64_t *x2,
                            const int64_t *pred_q13, int fs_khz,
                            int frame_length)
{
    int64_t pred0, pred1, delta0, delta1, denom_q16;
    int interp_len = STEREO_INTERP_LEN_MS * fs_khz;
    int n;
    x1[0] = s->sMid[0];
    x1[1] = s->sMid[1];
    x2[0] = s->sSide[0];
    x2[1] = s->sSide[1];
    s->sMid[0] = x1[frame_length];
    s->sMid[1] = x1[frame_length + 1];
    s->sSide[0] = x2[frame_length];
    s->sSide[1] = x2[frame_length + 1];
    pred0 = s->pred_prev_Q13[0];
    pred1 = s->pred_prev_Q13[1];
    denom_q16 = ((int64_t)1 << 16) / (STEREO_INTERP_LEN_MS * fs_khz);
    delta0 = RSHIFT_ROUND(
        SMULBB(pred_q13[0] - s->pred_prev_Q13[0], denom_q16), 16);
    delta1 = RSHIFT_ROUND(
        SMULBB(pred_q13[1] - s->pred_prev_Q13[1], denom_q16), 16);
    for (n = 0; n < interp_len; n++) {
        int64_t sm;
        pred0 += delta0;
        pred1 += delta1;
        sm = (x1[n] + x1[n + 2] + 2 * x1[n + 1]) << 9;
        sm = SMLAWB(I32(x2[n + 1] << 8), sm, pred0);
        sm = SMLAWB(sm, I32(x1[n + 1] << 11), pred1);
        x2[n + 1] = SAT16(RSHIFT_ROUND(sm, 8));
    }
    pred0 = pred_q13[0];
    pred1 = pred_q13[1];
    for (n = interp_len; n < frame_length; n++) {
        int64_t sm = (x1[n] + x1[n + 2] + 2 * x1[n + 1]) << 9;
        sm = SMLAWB(I32(x2[n + 1] << 8), sm, pred0);
        sm = SMLAWB(sm, I32(x1[n + 1] << 11), pred1);
        x2[n + 1] = SAT16(RSHIFT_ROUND(sm, 8));
    }
    s->pred_prev_Q13[0] = pred_q13[0];
    s->pred_prev_Q13[1] = pred_q13[1];
    for (n = 0; n < frame_length; n++) {
        int64_t ssum = x1[n + 1] + x2[n + 1];
        int64_t diff = x1[n + 1] - x2[n + 1];
        x1[n + 1] = SAT16(ssum);
        x2[n + 1] = SAT16(diff);
    }
}

/* ---------------- in-band FEC ----------------- */

/* One LBRR frame decoded as decode_frame.c does under FLAG_DECODE_LBRR:
   the indices and pulses are already read; parameters, core, the PLC
   state update, the output buffer, glue and CNG follow. */
static void decode_lbrr_frame(chan_state *st, int cond_coding,
                              const int *pulses, int64_t *xq)
{
    frame_params params;
    int mv, i;
    decode_parameters(st, cond_coding, &params);
    decode_core(st, &params, pulses, xq);
    silk_plc(st, &params, xq, 0);
    st->lossCnt = 0;
    st->prevSignalType = st->ind.signalType;
    st->first_frame_after_reset = 0;
    mv = st->ltp_mem_length - st->frame_length;
    for (i = 0; i < mv; i++)
        st->outBuf[i] = st->outBuf[st->frame_length + i];
    for (i = 0; i < st->frame_length; i++)
        st->outBuf[mv + i] = xq[i];
    plc_glue(st, xq, st->frame_length);
    silk_cng(st, &params, xq, st->frame_length);
    st->lagPrev = params.pitchL[st->nb_subfr - 1];
}

/* The recovered frame at 48 kHz: stereo through the mid/side predictor
   of LBRR frame 0 when both channels carry one, else the mid channel
   with the regular path's one-sample delay, on every API channel.
   Returns n_out, or -2 when the packet carries no LBRR frame. */
static int64_t fec_output(silk_state *s, int n_channels_internal,
                          const int *have, int64_t (*xq)[MAX_FRAME_LENGTH],
                          const int64_t *pred_q13, int16_t *out)
{
    chan_state *cs = s->ch;
    int frame_len = cs[0].frame_length;
    int n_out = frame_len * 48 / cs[0].fs_kHz;
    int64_t samples1[2][MAX_FRAME_LENGTH + 2];
    int32_t xin[MAX_FRAME_LENGTH + 2];
    int32_t res[MAX_FRAME_LENGTH * 6];
    int n, i, nres, c;
    if (!have[0]) return -2;
    memset(samples1, 0, sizeof(samples1));
    if (s->nChannelsAPI == 2 && n_channels_internal == 2 && have[1]) {
        stereo_io sio;
        for (n = 0; n < 2; n++)
            for (i = 0; i < frame_len; i++)
                samples1[n][2 + i] = xq[n][i];
        sio.pred_prev_Q13[0] = s->stereo_pred_prev[0];
        sio.pred_prev_Q13[1] = s->stereo_pred_prev[1];
        sio.sMid[0] = s->sMid[0];
        sio.sMid[1] = s->sMid[1];
        sio.sSide[0] = s->sSide[0];
        sio.sSide[1] = s->sSide[1];
        stereo_ms_to_lr(&sio, samples1[0], samples1[1], pred_q13,
                        cs[0].fs_kHz, frame_len);
        s->stereo_pred_prev[0] = sio.pred_prev_Q13[0];
        s->stereo_pred_prev[1] = sio.pred_prev_Q13[1];
        s->sMid[0] = sio.sMid[0];
        s->sMid[1] = sio.sMid[1];
        s->sSide[0] = sio.sSide[0];
        s->sSide[1] = sio.sSide[1];
        for (n = 0; n < 2; n++) {
            for (i = 0; i < frame_len; i++)
                xin[i] = (int32_t)samples1[n][1 + i];
            nres = resampler_process(&cs[n].rs, xin, frame_len, res);
            for (i = 0; i < n_out; i++)
                out[i * 2 + n] = (int16_t)(i < nres ? res[i] : 0);
            cs[n].nFramesDecoded++;
        }
        return n_out;
    }
    xin[0] = (int32_t)s->sMid[1];
    for (i = 1; i < frame_len; i++)
        xin[i] = (int32_t)xq[0][i - 1];
    s->sMid[0] = xq[0][frame_len - 2];
    s->sMid[1] = xq[0][frame_len - 1];
    nres = resampler_process(&cs[0].rs, xin, frame_len, res);
    for (i = 0; i < n_out; i++)
        for (c = 0; c < s->nChannelsAPI; c++)
            out[i * s->nChannelsAPI + c] = (int16_t)(i < nres ? res[i] : 0);
    cs[0].nFramesDecoded++;
    return n_out;
}

/* ---------------- top-level decoder ---------- */

void *silk_create(int channels)
{
    silk_state *s = (silk_state *)calloc(1, sizeof(silk_state));
    if (!s) return 0;
    s->nChannelsAPI = channels;
    s->nChannelsInternal = 0;
    chan_init(&s->ch[0]);
    chan_init(&s->ch[1]);
    return s;
}

void silk_free(void *h) { free(h); }

/* Decode ONE 10/20 ms SILK frame group (the _decode_one equivalent);
   out is int16 interleaved [n_out * nChannelsAPI].  Returns n_out. */
static int64_t silk_decode_one(silk_state *s, ecdec *dec,
                               int n_channels_internal, int internal_rate,
                               int payload_ms, int new_packet,
                               int16_t *out, int lost, int fec)
{
    chan_state *cs = s->ch;
    int64_t ms_pred_q13[2] = {0, 0};
    int decode_only_middle = 0;
    int n, i, has_side, frame_len, n_out;
    int64_t samples1[2][MAX_FRAME_LENGTH + 2];
    stereo_io sio;
    int fec_have[2] = {0, 0};
    int64_t fec_xq[2][MAX_FRAME_LENGTH];
    int64_t fec_pred_q13[2] = {0, 0};

    if (new_packet)
        for (n = 0; n < n_channels_internal; n++)
            cs[n].nFramesDecoded = 0;
    if (n_channels_internal > s->nChannelsInternal)
        chan_init(&cs[1]);

    if (cs[0].nFramesDecoded == 0) {
        for (n = 0; n < n_channels_internal; n++) {
            int fs_khz;
            if (payload_ms == 0 || payload_ms == 10) {
                cs[n].nFramesPerPacket = 1;
                cs[n].nb_subfr = 2;
            }
            else if (payload_ms == 20) {
                cs[n].nFramesPerPacket = 1;
                cs[n].nb_subfr = 4;
            }
            else if (payload_ms == 40) {
                cs[n].nFramesPerPacket = 2;
                cs[n].nb_subfr = 4;
            }
            else if (payload_ms == 60) {
                cs[n].nFramesPerPacket = 3;
                cs[n].nb_subfr = 4;
            }
            else return -1;
            fs_khz = (internal_rate >> 10) + 1;
            chan_set_fs(&cs[n], fs_khz, 48000);
        }
    }

    if (s->nChannelsAPI == 2 && n_channels_internal == 2
        && s->nChannelsInternal == 1) {
        s->stereo_pred_prev[0] = 0;
        s->stereo_pred_prev[1] = 0;
        s->sSide[0] = 0;
        s->sSide[1] = 0;
        cs[1].rs = cs[0].rs;
        cs[1].rs_valid = cs[0].rs_valid;
    }
    s->nChannelsInternal = n_channels_internal;

    if (cs[0].nFramesDecoded == 0 && !lost) {
        for (n = 0; n < n_channels_internal; n++) {
            for (i = 0; i < cs[n].nFramesPerPacket; i++)
                cs[n].VAD_flags[i] = ec_dec_bit_logp(dec, 1);
            cs[n].LBRR_flag = ec_dec_bit_logp(dec, 1);
        }
        for (n = 0; n < n_channels_internal; n++) {
            cs[n].LBRR_flags[0] = 0;
            cs[n].LBRR_flags[1] = 0;
            cs[n].LBRR_flags[2] = 0;
            if (cs[n].LBRR_flag) {
                if (cs[n].nFramesPerPacket == 1)
                    cs[n].LBRR_flags[0] = 1;
                else {
                    int sym = ec_dec_icdf(
                        dec,
                        cs[n].nFramesPerPacket == 2 ? TU8[TU8_LBRR2]
                                                    : TU8[TU8_LBRR3],
                        8) + 1;
                    for (i = 0; i < cs[n].nFramesPerPacket; i++)
                        cs[n].LBRR_flags[i] = (sym >> i) & 1;
                }
            }
        }
        /* LBRR data: skipped on the normal path; on a recovery call
           (dec_API.c FLAG_DECODE_LBRR) the first LBRR frame of each
           channel is decoded in full and returned below */
        for (i = 0; i < cs[0].nFramesPerPacket; i++) {
            for (n = 0; n < n_channels_internal; n++) {
                if (cs[n].LBRR_flags[i]) {
                    int pulses_tmp[MAX_ITER * SHELL_FRAME];
                    int cond;
                    if (n_channels_internal == 2 && n == 0) {
                        int64_t tmp_pred[2];
                        stereo_decode_pred(dec, tmp_pred);
                        if (i == 0) {
                            fec_pred_q13[0] = tmp_pred[0];
                            fec_pred_q13[1] = tmp_pred[1];
                        }
                        if (cs[1].LBRR_flags[i] == 0)
                            ec_dec_icdf(dec, TU8[TU8_STEREO_MID], 8);
                    }
                    cond = (i > 0 && cs[n].LBRR_flags[i - 1])
                        ? CODE_CONDITIONALLY : CODE_INDEPENDENTLY;
                    decode_indices(&cs[n], dec, i, 1, cond);
                    decode_pulses(dec, cs[n].ind.signalType,
                                  cs[n].ind.quantOffsetType,
                                  cs[n].frame_length, pulses_tmp);
                    if (fec && i == 0 && !fec_have[n]) {
                        decode_lbrr_frame(&cs[n], cond, pulses_tmp,
                                          fec_xq[n]);
                        fec_have[n] = 1;
                    }
                }
            }
        }
        if (fec)
            return fec_output(s, n_channels_internal, fec_have, fec_xq,
                              fec_pred_q13, out);
    }

    if (n_channels_internal == 2) {
        if (!lost) {
            stereo_decode_pred(dec, ms_pred_q13);
            if (cs[1].VAD_flags[cs[0].nFramesDecoded] == 0)
                decode_only_middle =
                    ec_dec_icdf(dec, TU8[TU8_STEREO_MID], 8);
            else
                decode_only_middle = 0;
        }
        else {
            /* dec_API.c:237: reuse the previous MS predictors */
            ms_pred_q13[0] = s->stereo_pred_prev[0];
            ms_pred_q13[1] = s->stereo_pred_prev[1];
        }
    }

    if (n_channels_internal == 2 && decode_only_middle == 0
        && s->prev_decode_only_middle == 1) {
        memset(cs[1].outBuf, 0, sizeof(cs[1].outBuf));
        memset(cs[1].sLPC_Q14_buf, 0, sizeof(cs[1].sLPC_Q14_buf));
        cs[1].lagPrev = 100;
        cs[1].LastGainIndex = 10;
        cs[1].prevSignalType = TYPE_NO_VOICE_ACTIVITY;
        cs[1].first_frame_after_reset = 1;
    }

    has_side = lost ? !s->prev_decode_only_middle
                    : !decode_only_middle;
    frame_len = cs[0].frame_length;
    memset(samples1, 0, sizeof(samples1));
    for (n = 0; n < n_channels_internal; n++) {
        if (n == 0 || has_side) {
            int fi = cs[0].nFramesDecoded - n;
            int cond;
            int64_t xq[MAX_FRAME_LENGTH];
            if (fi <= 0) cond = CODE_INDEPENDENTLY;
            else if (n > 0 && s->prev_decode_only_middle)
                cond = CODE_INDEPENDENTLY_NO_LTP_SCALING;
            else cond = CODE_CONDITIONALLY;
            if (lost)
                decode_frame_lost(&cs[n], xq);
            else
                decode_frame(&cs[n], dec, cond, xq);
            for (i = 0; i < frame_len; i++)
                samples1[n][2 + i] = xq[i];
        }
        cs[n].nFramesDecoded++;
    }

    if (s->nChannelsAPI == 2 && n_channels_internal == 2) {
        sio.pred_prev_Q13[0] = s->stereo_pred_prev[0];
        sio.pred_prev_Q13[1] = s->stereo_pred_prev[1];
        sio.sMid[0] = s->sMid[0];
        sio.sMid[1] = s->sMid[1];
        sio.sSide[0] = s->sSide[0];
        sio.sSide[1] = s->sSide[1];
        stereo_ms_to_lr(&sio, samples1[0], samples1[1], ms_pred_q13,
                        cs[0].fs_kHz, frame_len);
        s->stereo_pred_prev[0] = sio.pred_prev_Q13[0];
        s->stereo_pred_prev[1] = sio.pred_prev_Q13[1];
        s->sMid[0] = sio.sMid[0];
        s->sMid[1] = sio.sMid[1];
        s->sSide[0] = sio.sSide[0];
        s->sSide[1] = sio.sSide[1];
    }
    else {
        samples1[0][0] = s->sMid[0];
        samples1[0][1] = s->sMid[1];
        s->sMid[0] = samples1[0][frame_len];
        s->sMid[1] = samples1[0][frame_len + 1];
    }

    n_out = frame_len * 48 / cs[0].fs_kHz;
    {
        int nch = s->nChannelsAPI < n_channels_internal
            ? s->nChannelsAPI : n_channels_internal;
        int32_t res[MAX_FRAME_LENGTH * 6];
        int32_t xin[MAX_FRAME_LENGTH + 2];
        for (n = 0; n < nch; n++) {
            int nres;
            for (i = 0; i < frame_len; i++)
                xin[i] = (int32_t)samples1[n][1 + i];
            nres = resampler_process(&cs[n].rs, xin, frame_len, res);
            for (i = 0; i < n_out; i++)
                out[i * s->nChannelsAPI + n] =
                    (int16_t)(i < nres ? res[i] : 0);
        }
        if (s->nChannelsAPI == 2 && n_channels_internal == 1)
            for (i = 0; i < n_out; i++)
                out[i * 2 + 1] = out[i * 2];
    }
    if (lost)
        /* dec_API.c:354: remove gain clamping so energy does not
           bounce back after losses */
        for (n = 0; n < n_channels_internal; n++)
            cs[n].LastGainIndex = 10;
    else
        s->prev_decode_only_middle = decode_only_middle;
    return n_out;
}

/* Decode all SILK frames of one Opus frame:
   repeats 20 ms groups until payload_ms is consumed.  ec state crosses
   the boundary as 10 int64s.  Returns total samples at 48 kHz per
   channel (out is interleaved int16 [total * nChannelsAPI]), or -1. */
int64_t silk_decode(void *h, const uint8_t *buf, uint32_t storage,
                    int64_t *ec, int n_channels_internal,
                    int internal_rate, int payload_ms, int16_t *out)
{
    silk_state *s = (silk_state *)h;
    ecdec dec;
    int remaining_ms = payload_ms, first = 1;
    int64_t total = 0;
    if (!tables_ready || !s) return -1;
    ec_load(&dec, buf, storage, ec);
    while (remaining_ms > 0) {
        int chunk_ms = payload_ms >= 20 ? 20 : payload_ms;
        int64_t n = silk_decode_one(s, &dec, n_channels_internal,
                                    internal_rate, payload_ms, first,
                                    out + total * s->nChannelsAPI, 0, 0);
        if (n < 0) return -1;
        total += n;
        remaining_ms -= chunk_ms;
        first = 0;
    }
    ec_store(&dec, ec);
    return total;
}

/* Conceal one lost Opus SILK frame (reference opus_decoder_clean.c lost
   path -> silk_Decode(FLAG_PACKET_LOST); PLC.c + CNG.c).  Caller passes
   the LAST GOOD packet's configuration.  Returns total samples at
   48 kHz per channel (out interleaved int16), or -1. */
int64_t silk_decode_lost(void *h, int n_channels_internal,
                         int internal_rate, int payload_ms, int16_t *out)
{
    silk_state *s = (silk_state *)h;
    int remaining_ms = payload_ms, first = 1;
    int64_t total = 0;
    if (!tables_ready || !s) return -1;
    while (remaining_ms > 0) {
        int chunk_ms = payload_ms >= 20 ? 20 : payload_ms;
        int64_t n = silk_decode_one(s, 0, n_channels_internal,
                                    internal_rate, payload_ms, first,
                                    out + total * s->nChannelsAPI, 1, 0);
        if (n < 0) return -1;
        total += n;
        remaining_ms -= chunk_ms;
        first = 0;
    }
    return total;
}

/* Recover the frame lost before this packet from the packet's first
   LBRR frame (opus_decode(..., decode_fec=1); dec_API.c
   FLAG_DECODE_LBRR): one 10 or 20 ms frame at 48 kHz, out interleaved
   int16 [n * nChannelsAPI]. The range decoder starts at the frame's
   first byte. Returns n, -2 when the packet carries no LBRR data, or
   -1. */
int64_t silk_decode_fec(void *h, const uint8_t *buf, uint32_t storage,
                        int n_channels_internal, int internal_rate,
                        int payload_ms, int16_t *out)
{
    silk_state *s = (silk_state *)h;
    ecdec dec;
    if (!tables_ready || !s) return -1;
    ec_init(&dec, buf, storage);
    return silk_decode_one(s, &dec, n_channels_internal, internal_rate,
                           payload_ms, 1, out, 0, 1);
}
