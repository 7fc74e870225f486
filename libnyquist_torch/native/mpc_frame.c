/* Native Musepack frame entropy decode (SV7 + SV8).
 *
 * Mirrors the reference libmpcdec frame reader
 * (third_party/musepack/libmpcdec/mpc_decoder.c:346,
 * mpc_bits_reader.{c,h}): canonical-huffman and SV7 lut decodes,
 * enumerative MS flags and Q1 positions, DSCF deltas.  The per-symbol
 * huffman loops are what bound Musepack host throughput, so they run
 * here; formats/musepack.py calls them through ctypes and has no
 * Python frame reader.
 *
 * Huffman tables are NOT compiled in: formats/musepack.py loads
 * data/mpc_tables.npz and hands the row/symbol blobs over once via
 * mpc_set_tables.
 * Decoder state (res/scfi/scf/q/...) stays in the caller's numpy
 * arrays; only scalars round-trip through small io arrays.
 */
#include <stdint.h>
#include <string.h>

/* ----------------------------- tables ----------------------------- */

enum {
    CAN_BANDS = 0, CAN_SCFI_1, CAN_SCFI_2, CAN_DSCF_1, CAN_DSCF_2,
    CAN_RES_1, CAN_RES_2, CAN_Q1, CAN_Q9UP,
    CAN_Q2_1, CAN_Q2_2, CAN_Q3, CAN_Q4, CAN_Q5_1, CAN_Q5_2,
    CAN_Q6_1, CAN_Q6_2, CAN_Q7_1, CAN_Q7_2, CAN_Q8_1, CAN_Q8_2,
    CAN_COUNT
};

enum {
    LUT_HDR7 = 0, LUT_SCFI7, LUT_DSCF7,
    LUT_Q7_1_0, LUT_Q7_1_1, LUT_Q7_2_0, LUT_Q7_2_1,
    LUT_Q7_3_0, LUT_Q7_3_1, LUT_Q7_4_0, LUT_Q7_4_1,
    LUT_Q7_5_0, LUT_Q7_5_1, LUT_Q7_6_0, LUT_Q7_6_1,
    LUT_Q7_7_0, LUT_Q7_7_1,
    LUT_COUNT
};

typedef struct {
    const int32_t *rows;    /* [n][3] code, length, value */
    int n;
    const int8_t *sym;
} can_tab;

typedef struct {
    const int32_t *rows;    /* [n][3] code, length, value */
    int n;
} lut_tab;

static can_tab CAN[CAN_COUNT];
static lut_tab LUT[LUT_COUNT];
static const int32_t *DC;       /* index by res + 1 */
static const int32_t *RES_BIT;  /* index by res (SV7) */
static int mpc_tables_ready = 0;

/* derived tables (the SV7/SV8 quantizer index expansions) */
static int IDX50[125], IDX51[125], IDX52[125], HUFFQ2_VAR[125];
static int IDX30_7[27], IDX31_7[27], IDX32_7[27];
static int IDX50_7[25], IDX51_7[25];
static const int THRES[9] = {0, 0, 3, 0, 0, 1, 3, 4, 8};
static uint64_t COMB[17][33];   /* C(n, k), mpc_bits_reader.c:40 */

void mpc_set_tables(const int32_t *can_rows, const int8_t *can_syms,
                    const int64_t *can_meta,   /* [CAN_COUNT][3] */
                    const int32_t *lut_rows,
                    const int64_t *lut_meta,   /* [LUT_COUNT][2] */
                    const int32_t *dc, const int32_t *res_bit)
{
    int i, k, n;
    for (i = 0; i < CAN_COUNT; i++) {
        CAN[i].rows = can_rows + can_meta[i * 3 + 0] * 3;
        CAN[i].n = (int)can_meta[i * 3 + 1];
        CAN[i].sym = can_syms + can_meta[i * 3 + 2];
    }
    for (i = 0; i < LUT_COUNT; i++) {
        LUT[i].rows = lut_rows + lut_meta[i * 2 + 0] * 3;
        LUT[i].n = (int)lut_meta[i * 2 + 1];
    }
    DC = dc;
    RES_BIT = res_bit;
    for (i = 0; i < 125; i++) {
        IDX50[i] = i % 5 - 2;
        IDX51[i] = (i / 5) % 5 - 2;
        IDX52[i] = i / 25 - 2;
        HUFFQ2_VAR[i] = (IDX50[i] < 0 ? -IDX50[i] : IDX50[i])
            + (IDX51[i] < 0 ? -IDX51[i] : IDX51[i])
            + (IDX52[i] < 0 ? -IDX52[i] : IDX52[i]);
    }
    for (i = 0; i < 27; i++) {
        IDX30_7[i] = i % 3 - 1;
        IDX31_7[i] = (i / 3) % 3 - 1;
        IDX32_7[i] = i / 9 - 1;
    }
    for (i = 0; i < 25; i++) {
        IDX50_7[i] = i % 5 - 2;
        IDX51_7[i] = i / 5 - 2;
    }
    for (k = 0; k <= 16; k++)
        for (n = 0; n <= 32; n++) {
            if (k == 0) COMB[k][n] = 1;
            else if (n == 0) COMB[k][n] = 0;
            else COMB[k][n] = COMB[k - 1][n - 1] + COMB[k][n - 1];
        }
    mpc_tables_ready = 1;
}

/* ---------------------------- bitreader --------------------------- */

typedef struct {
    const uint8_t *buf;     /* padded with >= 8 zero bytes by caller */
    int64_t pos;
} bits;

static inline uint32_t br_read(bits *b, int n) {
    int64_t p, first, last;
    uint64_t chunk = 0;
    int i;
    if (n <= 0) return 0;
    p = b->pos;
    b->pos = p + n;
    first = p >> 3;
    last = (p + n - 1) >> 3;
    for (i = 0; i <= (int)(last - first); i++)
        chunk = (chunk << 8) | b->buf[first + i];
    chunk >>= ((last + 1) << 3) - (p + n);
    return (uint32_t)(chunk & (((uint64_t)1 << n) - 1));
}

static inline uint32_t br_peek16(const bits *b) {
    int64_t first = b->pos >> 3;
    uint32_t chunk = ((uint32_t)b->buf[first] << 16)
        | ((uint32_t)b->buf[first + 1] << 8)
        | (uint32_t)b->buf[first + 2];
    return (chunk >> (8 - (b->pos & 7))) & 0xFFFF;
}

static int can_dec(bits *b, const can_tab *t) {
    uint32_t code = br_peek16(b);
    int i;
    for (i = 0; i < t->n; i++) {
        uint32_t c = (uint32_t)t->rows[i * 3 + 0];
        if (code >= c) {
            int length = t->rows[i * 3 + 1];
            int v = t->rows[i * 3 + 2];
            b->pos += length;
            return t->sym[(v - (int)(code >> (16 - length))) & 0xFF];
        }
    }
    return -1000000;    /* bad code: caller propagates error */
}

static int lut_dec(bits *b, const lut_tab *t) {
    uint32_t code = br_peek16(b);
    int i;
    for (i = 0; i < t->n; i++) {
        uint32_t c = (uint32_t)t->rows[i * 3 + 0];
        if (code >= c) {
            b->pos += t->rows[i * 3 + 1];
            return t->rows[i * 3 + 2];
        }
    }
    return -1000000;
}

static int bitlen(uint32_t v) {
    int r = 0;
    while (v) { r++; v >>= 1; }
    return r;
}

static uint32_t log_dec(bits *b, uint32_t mx) {
    int ln;
    uint32_t lost, value;
    if (mx == 0) return 0;
    ln = bitlen(mx);
    lost = ((uint32_t)1 << ln) - 1 - mx;
    value = ln > 1 ? br_read(b, ln - 1) : 0;
    if (value >= lost) value = ((value << 1) | br_read(b, 1)) - lost;
    return value;
}

static uint32_t enum_dec(bits *b, int k, int n) {
    uint64_t total = COMB[k][n];
    int ln = bitlen((uint32_t)(total - 1));
    uint64_t lost = ((uint64_t)1 << ln) - total;
    uint64_t code = br_read(b, ln - 1);
    uint32_t out = 0;
    if (code >= lost) code = ((code << 1) | br_read(b, 1)) - lost;
    while (k > 0) {
        uint64_t c;
        n--;
        c = COMB[k][n];
        if (code >= c) {
            out |= (uint32_t)1 << n;
            code -= c;
            k--;
        }
    }
    return out;
}

/* random generator for Res == -1 bands (synth_filter.c:414) */
static inline uint32_t random_int(uint32_t *r1, uint32_t *r2) {
    uint32_t t1 = __builtin_parity(*r1 & 0xF5);
    uint32_t t2 = __builtin_parity((*r2 >> 25) & 0x63);
    *r1 = (*r1 >> 1) | (t1 << 31);
    *r2 = (*r2 << 1) | t2;
    return *r1 ^ *r2;
}

#define BAD(v) ((v) <= -1000000)

/* ------------------------- SV8 frame read ------------------------- */

static int64_t read_frame_sv8(
    bits *br, int is_key_frame, int max_band, int ms,
    int32_t *res_l, int32_t *res_r, int32_t *scfi_l, int32_t *scfi_r,
    int32_t *scf_l, int32_t *scf_r,     /* [32][3] */
    int32_t *dscf_l, int32_t *dscf_r, int32_t *ms_flag,
    int32_t *q_l, int32_t *q_r,         /* [32][36] */
    uint32_t *r1, uint32_t *r2, int32_t *last_max_band)
{
    int max_used, n, ch, m, k, v;
    int32_t *res_c[2], *scfi_c[2], *scf_c[2], *dscf_c[2], *q_c[2];
    res_c[0] = res_l; res_c[1] = res_r;
    scfi_c[0] = scfi_l; scfi_c[1] = scfi_r;
    scf_c[0] = scf_l; scf_c[1] = scf_r;
    dscf_c[0] = dscf_l; dscf_c[1] = dscf_r;
    q_c[0] = q_l; q_c[1] = q_r;

    if (is_key_frame) {
        max_used = (int)log_dec(br, (uint32_t)(max_band + 1));
    }
    else {
        v = can_dec(br, &CAN[CAN_BANDS]);
        if (BAD(v)) return -1;
        max_used = *last_max_band + v;
        if (max_used > 32) max_used -= 33;
    }
    *last_max_band = max_used;

    if (max_used) {
        v = can_dec(br, &CAN[CAN_RES_1]);
        if (BAD(v)) return -1;
        res_l[max_used - 1] = v > 15 ? v - 17 : v;
        v = can_dec(br, &CAN[CAN_RES_1]);
        if (BAD(v)) return -1;
        res_r[max_used - 1] = v > 15 ? v - 17 : v;
        for (n = max_used - 2; n >= 0; n--) {
            v = can_dec(br, &CAN[res_l[n + 1] > 2 ? CAN_RES_2
                                                  : CAN_RES_1]);
            if (BAD(v)) return -1;
            v += res_l[n + 1];
            res_l[n] = v > 15 ? v - 17 : v;
            v = can_dec(br, &CAN[res_r[n + 1] > 2 ? CAN_RES_2
                                                  : CAN_RES_1]);
            if (BAD(v)) return -1;
            v += res_r[n + 1];
            res_r[n] = v > 15 ? v - 17 : v;
        }
        if (ms) {
            int tot = 0, cnt;
            uint32_t tmp = 0;
            for (n = 0; n < max_used; n++)
                if (res_l[n] != 0 || res_r[n] != 0) tot++;
            cnt = (int)log_dec(br, (uint32_t)tot);
            if (cnt != 0 && cnt != tot)
                tmp = enum_dec(br, cnt < tot - cnt ? cnt : tot - cnt,
                               tot);
            if (cnt * 2 > tot) tmp = ~tmp;
            for (n = max_used - 1; n >= 0; n--)
                if (res_l[n] != 0 || res_r[n] != 0) {
                    ms_flag[n] = (int32_t)(tmp & 1);
                    tmp >>= 1;
                }
        }
    }
    for (n = max_used; n <= max_band && n < 32; n++) {
        res_l[n] = 0;
        res_r[n] = 0;
    }

    /* SCFI */
    if (is_key_frame)
        for (n = 0; n < 32; n++) {
            dscf_l[n] = 1;
            dscf_r[n] = 1;
        }
    for (n = 0; n < max_used; n++) {
        int cnt = -1;
        if (res_l[n]) cnt++;
        if (res_r[n]) cnt++;
        if (cnt >= 0) {
            v = can_dec(br, &CAN[CAN_SCFI_1 + cnt]);
            if (BAD(v)) return -1;
            if (res_l[n]) scfi_l[n] = v >> (2 * cnt);
            if (res_r[n]) scfi_r[n] = v & 3;
        }
    }

    /* SCF / DSCF */
    for (n = 0; n < max_used; n++) {
        for (ch = 0; ch < 2; ch++) {
            int32_t *scf;
            int scfi;
            if (!res_c[ch][n]) continue;
            scf = scf_c[ch] + n * 3;
            if (dscf_c[ch][n] == 1) {
                scf[0] = (int32_t)br_read(br, 7) - 6;
                dscf_c[ch][n] = 0;
            }
            else {
                v = can_dec(br, &CAN[CAN_DSCF_2]);
                if (BAD(v)) return -1;
                if (v == 64) v += br_read(br, 6);
                scf[0] = ((scf[2] - 25 + v) & 127) - 6;
            }
            scfi = scfi_c[ch][n];
            for (m = 0; m < 2; m++) {
                if (((scfi << m) & 2) == 0) {
                    v = can_dec(br, &CAN[CAN_DSCF_1]);
                    if (BAD(v)) return -1;
                    if (v == 31) v = 64 + br_read(br, 6);
                    scf[m + 1] = ((scf[m] - 25 + v) & 127) - 6;
                }
                else scf[m + 1] = scf[m];
            }
        }
    }

    /* samples */
    for (n = 0; n < max_used; n++) {
        for (ch = 0; ch < 2; ch++) {
            int32_t *q = q_c[ch] + n * 36;
            int res = res_c[ch][n];
            if (res == 0) continue;
            if (res == 2) {
                int idx = 2 * THRES[2];
                for (k = 0; k < 36; k += 3) {
                    v = can_dec(br, &CAN[idx > THRES[2] ? CAN_Q2_2
                                                        : CAN_Q2_1]);
                    if (BAD(v)) return -1;
                    q[k] = IDX50[v];
                    q[k + 1] = IDX51[v];
                    q[k + 2] = IDX52[v];
                    idx = (idx >> 1) + HUFFQ2_VAR[v];
                }
            }
            else if (res == 1) {
                int k0;
                for (k0 = 0; k0 <= 18; k0 += 18) {
                    int cnt = can_dec(br, &CAN[CAN_Q1]);
                    uint32_t idx = 0;
                    if (BAD(cnt)) return -1;
                    if (0 < cnt && cnt < 18)
                        idx = enum_dec(br, cnt <= 9 ? cnt : 18 - cnt,
                                       18);
                    if (cnt > 9) idx = (~idx) & 0x3FFFF;
                    for (k = k0; k < k0 + 18; k++) {
                        q[k] = 0;
                        if (idx & ((uint32_t)1 << 17))
                            q[k] = ((int32_t)br_read(br, 1) << 1) - 1;
                        idx = (idx << 1) & 0x3FFFF;
                    }
                }
            }
            else if (res == -1) {
                for (k = 0; k < 36; k++) {
                    uint32_t t = random_int(r1, r2);
                    q[k] = (int32_t)(((t >> 24) & 0xFF)
                                     + ((t >> 16) & 0xFF)
                                     + ((t >> 8) & 0xFF)
                                     + (t & 0xFF)) - 510;
                }
            }
            else if (res <= 4) {
                int tab = res == 3 ? CAN_Q3 : CAN_Q4;
                for (k = 0; k < 36; k += 2) {
                    v = can_dec(br, &CAN[tab]);
                    if (BAD(v)) return -1;
                    v &= 0xFF;
                    q[k] = ((v & 0xF) ^ 8) - 8;
                    q[k + 1] = (((v >> 4) & 0xF) ^ 8) - 8;
                }
            }
            else if (res <= 8) {
                /* T["Q"][res-3] pairs: res 5 -> Q5_1/2, ... 8 -> Q8_1/2 */
                int base = CAN_Q5_1 + (res - 5) * 2;
                int th = THRES[res];
                int idx = 2 * th;
                for (k = 0; k < 36; k++) {
                    v = can_dec(br, &CAN[idx > th ? base + 1 : base]);
                    if (BAD(v)) return -1;
                    q[k] = v;
                    idx = (idx >> 1) + (v < 0 ? -v : v);
                }
            }
            else {
                int dc = DC[res + 1];
                for (k = 0; k < 36; k++) {
                    v = can_dec(br, &CAN[CAN_Q9UP]);
                    if (BAD(v)) return -1;
                    v &= 0xFF;
                    if (res != 9)
                        v = (v << (res - 9)) | (int)br_read(br, res - 9);
                    q[k] = v - dc;
                }
            }
        }
    }
    return 0;
}

/* ------------------------- SV7 frame read ------------------------- */

static int dscf7(bits *br, int prev, int *err) {
    int idx = lut_dec(br, &LUT[LUT_DSCF7]);
    if (BAD(idx)) { *err = 1; return 0; }
    return idx != 8 ? prev + idx : (int)br_read(br, 6);
}

static int64_t read_frame_sv7(
    bits *br, int max_band, int ms,
    int32_t *res_l, int32_t *res_r, int32_t *scfi_l, int32_t *scfi_r,
    int32_t *scf_l, int32_t *scf_r, int32_t *ms_flag,
    int32_t *q_l, int32_t *q_r,
    uint32_t *r1, uint32_t *r2)
{
    int max_used = 0, n, ch, m, k, idx, err = 0;
    int32_t *res_c[2], *scfi_c[2], *scf_c[2], *q_c[2];
    res_c[0] = res_l; res_c[1] = res_r;
    scfi_c[0] = scfi_l; scfi_c[1] = scfi_r;
    scf_c[0] = scf_l; scf_c[1] = scf_r;
    q_c[0] = q_l; q_c[1] = q_r;

    res_l[0] = (int32_t)br_read(br, 4);
    res_r[0] = (int32_t)br_read(br, 4);
    if (res_l[0] || res_r[0]) {
        if (ms) ms_flag[0] = (int32_t)br_read(br, 1);
        max_used = 1;
    }
    for (n = 1; n <= max_band; n++) {
        idx = lut_dec(br, &LUT[LUT_HDR7]);
        if (BAD(idx)) return -1;
        res_l[n] = idx != 4 ? res_l[n - 1] + idx : (int32_t)br_read(br, 4);
        idx = lut_dec(br, &LUT[LUT_HDR7]);
        if (BAD(idx)) return -1;
        res_r[n] = idx != 4 ? res_r[n - 1] + idx : (int32_t)br_read(br, 4);
        /* corrupt streams can walk Res out of table range via the
           unbounded delta chain; valid SV7 stays within [-17, 17] */
        if (res_l[n] < -17 || res_l[n] > 17
            || res_r[n] < -17 || res_r[n] > 17) return -1;
        if (res_l[n] || res_r[n]) {
            if (ms) ms_flag[n] = (int32_t)br_read(br, 1);
            max_used = n + 1;
        }
    }

    for (n = 0; n < max_used; n++) {
        if (res_l[n]) {
            idx = lut_dec(br, &LUT[LUT_SCFI7]);
            if (BAD(idx)) return -1;
            scfi_l[n] = idx;
        }
        if (res_r[n]) {
            idx = lut_dec(br, &LUT[LUT_SCFI7]);
            if (BAD(idx)) return -1;
            scfi_r[n] = idx;
        }
    }

    for (n = 0; n < max_used; n++) {
        for (ch = 0; ch < 2; ch++) {
            int32_t *scf;
            int scfi;
            if (!res_c[ch][n]) continue;
            scf = scf_c[ch] + n * 3;
            scfi = scfi_c[ch][n];
            if (scfi == 1) {
                scf[0] = dscf7(br, scf[2], &err);
                scf[1] = dscf7(br, scf[0], &err);
                scf[2] = scf[1];
            }
            else if (scfi == 3) {
                scf[0] = dscf7(br, scf[2], &err);
                scf[1] = scf[0];
                scf[2] = scf[1];
            }
            else if (scfi == 2) {
                scf[0] = dscf7(br, scf[2], &err);
                scf[1] = scf[0];
                scf[2] = dscf7(br, scf[1], &err);
            }
            else {
                scf[0] = dscf7(br, scf[2], &err);
                scf[1] = dscf7(br, scf[0], &err);
                scf[2] = dscf7(br, scf[1], &err);
            }
            if (err) return -1;
            for (m = 0; m < 3; m++)
                if (scf[m] > 1024) scf[m] = 0x8080;
        }
    }

    for (n = 0; n < max_used; n++) {
        for (ch = 0; ch < 2; ch++) {
            int32_t *q = q_c[ch] + n * 36;
            int res = res_c[ch][n];
            if (res == 0 || res <= -2) continue;
            if (res == -1) {
                for (k = 0; k < 36; k++) {
                    uint32_t t = random_int(r1, r2);
                    q[k] = (int32_t)(((t >> 24) & 0xFF)
                                     + ((t >> 16) & 0xFF)
                                     + ((t >> 8) & 0xFF)
                                     + (t & 0xFF)) - 510;
                }
            }
            else if (res == 1) {
                int tab = LUT_Q7_1_0 + (int)br_read(br, 1);
                for (k = 0; k < 36; k += 3) {
                    idx = lut_dec(br, &LUT[tab]);
                    if (BAD(idx)) return -1;
                    q[k] = IDX30_7[idx];
                    q[k + 1] = IDX31_7[idx];
                    q[k + 2] = IDX32_7[idx];
                }
            }
            else if (res == 2) {
                int tab = LUT_Q7_2_0 + (int)br_read(br, 1);
                for (k = 0; k < 36; k += 2) {
                    idx = lut_dec(br, &LUT[tab]);
                    if (BAD(idx)) return -1;
                    q[k] = IDX50_7[idx];
                    q[k + 1] = IDX51_7[idx];
                }
            }
            else if (res <= 7) {
                int tab = LUT_Q7_1_0 + (res - 1) * 2 + (int)br_read(br, 1);
                for (k = 0; k < 36; k++) {
                    idx = lut_dec(br, &LUT[tab]);
                    if (BAD(idx)) return -1;
                    q[k] = idx;
                }
            }
            else {
                int nbits = RES_BIT[res];
                int dc = DC[res + 1];
                for (k = 0; k < 36; k++)
                    q[k] = (int32_t)br_read(br, nbits) - dc;
            }
        }
    }
    return 0;
}

/* ----------------------------- entry ------------------------------ */

/* buf must be padded with >= 8 zero bytes past buf_len (the
 * _Bits reader of formats/musepack.py guarantees this).  io[0..3] = pos, r1, r2,
 * last_max_band (in/out).  Returns 0 or -1 on a bad huffman code. */
int64_t mpc_read_frame(
    const uint8_t *buf, int64_t buf_len, int64_t *io,
    int sv7, int is_key_frame, int max_band, int ms,
    int32_t *res_l, int32_t *res_r, int32_t *scfi_l, int32_t *scfi_r,
    int32_t *scf_l, int32_t *scf_r,
    int32_t *dscf_l, int32_t *dscf_r, int32_t *ms_flag,
    int32_t *q_l, int32_t *q_r)
{
    bits br;
    uint32_t r1 = (uint32_t)io[1], r2 = (uint32_t)io[2];
    int32_t last_max_band = (int32_t)io[3];
    int64_t rc;
    (void)buf_len;
    if (!mpc_tables_ready) return -2;
    if (max_band < 0 || max_band > 31) return -1;
    br.buf = buf;
    br.pos = io[0];
    if (sv7)
        rc = read_frame_sv7(&br, max_band, ms, res_l, res_r,
                            scfi_l, scfi_r, scf_l, scf_r, ms_flag,
                            q_l, q_r, &r1, &r2);
    else
        rc = read_frame_sv8(&br, is_key_frame, max_band, ms,
                            res_l, res_r, scfi_l, scfi_r, scf_l, scf_r,
                            dscf_l, dscf_r, ms_flag, q_l, q_r,
                            &r1, &r2, &last_max_band);
    io[0] = br.pos;
    io[1] = r1;
    io[2] = r2;
    io[3] = last_max_band;
    return rc;
}

/* Decode n_frames SV8 frames in sequence (one AP block or a prefix of
 * it), snapshotting each frame's (q, res, scf, ms) for the caller's
 * batched requantization.  Same io/state conventions as
 * mpc_read_frame; key_first marks the block's first frame.
 * Snapshots: q_out [n][2][32][36], res_out [n][2][32],
 * scf_out [n][2][32][3], ms_out [n][32].
 * Returns 0 or -1 on a bad huffman code. */
int64_t mpc_read_frames_sv8(
    const uint8_t *buf, int64_t buf_len, int64_t *io,
    int n_frames, int key_first, int max_band, int ms,
    int32_t *res_l, int32_t *res_r, int32_t *scfi_l, int32_t *scfi_r,
    int32_t *scf_l, int32_t *scf_r,
    int32_t *dscf_l, int32_t *dscf_r, int32_t *ms_flag,
    int32_t *q_l, int32_t *q_r,
    int32_t *q_out, int32_t *res_out, int32_t *scf_out, int32_t *ms_out)
{
    bits br;
    uint32_t r1 = (uint32_t)io[1], r2 = (uint32_t)io[2];
    int32_t last_max_band = (int32_t)io[3];
    int f;
    (void)buf_len;
    if (!mpc_tables_ready) return -2;
    if (max_band < 0 || max_band > 31) return -1;
    br.buf = buf;
    br.pos = io[0];
    for (f = 0; f < n_frames; f++) {
        int64_t rc = read_frame_sv8(
            &br, key_first && f == 0 ? 1 : 0, max_band, ms,
            res_l, res_r, scfi_l, scfi_r, scf_l, scf_r,
            dscf_l, dscf_r, ms_flag, q_l, q_r,
            &r1, &r2, &last_max_band);
        if (rc) {
            io[0] = br.pos;
            io[1] = r1;
            io[2] = r2;
            io[3] = last_max_band;
            return rc;
        }
        memcpy(q_out + (int64_t)f * 2 * 32 * 36, q_l,
               sizeof(int32_t) * 32 * 36);
        memcpy(q_out + (int64_t)f * 2 * 32 * 36 + 32 * 36, q_r,
               sizeof(int32_t) * 32 * 36);
        memcpy(res_out + (int64_t)f * 2 * 32, res_l,
               sizeof(int32_t) * 32);
        memcpy(res_out + (int64_t)f * 2 * 32 + 32, res_r,
               sizeof(int32_t) * 32);
        memcpy(scf_out + (int64_t)f * 2 * 32 * 3, scf_l,
               sizeof(int32_t) * 32 * 3);
        memcpy(scf_out + (int64_t)f * 2 * 32 * 3 + 32 * 3, scf_r,
               sizeof(int32_t) * 32 * 3);
        memcpy(ms_out + (int64_t)f * 32, ms_flag,
               sizeof(int32_t) * 32);
    }
    io[0] = br.pos;
    io[1] = r1;
    io[2] = r2;
    io[3] = last_max_band;
    return 0;
}
