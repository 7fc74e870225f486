/* Whole-stream MP3 Layer-III entropy decoder: one C call walks every
 * frame of a buffer — sync, side info, bit reservoir, scalefactors,
 * Huffman (mp3_huff.c), stereo, reorder, antialias — and emits
 * frequency-domain granule planes [G, 2, 576] plus per-band IMDCT
 * kinds, ready for the batched matmul synthesis (ops/mp3_synth.py).
 *
 * minimp3.h L3_* semantics; formats/mp3.py binds it and keeps the
 * header helpers and the Layer I/II frame decoder in Python. The host
 * entropy plane is native because it is branchy and byte-serial;
 * everything dense runs on the device.
 */
#include <stdint.h>
#include <string.h>
#include <math.h>

#define HDR_SIZE 4
#define MAX_FRAME_SYNC_MATCHES 10
#define MAX_FREE_FORMAT_FRAME_SIZE 2304
#define MAX_BITRESERVOIR_BYTES 511
#define SHORT_BLOCK_TYPE 2
#define MAX_SCFI 48

/* from mp3_huff.c */
void mp3_l3_huffman(
    float *dst, const uint8_t *buf, int64_t buflen, int64_t pos_bits,
    const int32_t *tabs, const int32_t *tab32, const int32_t *tab33,
    const int32_t *tabindex, const int32_t *g_linbits,
    const double *g_pow43, const int32_t *sfb, const double *scf,
    int big_values, const int32_t *table_select,
    const int32_t *region_count, int count1_table, int64_t layer3gr_limit,
    int32_t tabs_len);

/* ------------------------------------------------------------------ */
/* tables (set once by formats/mp3.py, which keeps the arrays alive) */
static const int32_t *Ttabs, *Ttab32, *Ttab33, *Ttabindex, *Tlinbits;
static const double *Tpow43;
static const int32_t *Tscf_long, *Tscf_short, *Tscf_mixed; /* [8][23/40/40] */
static const int32_t *Tscfc_decode, *Tmod, *Tpreamp;
static const double *Texpfrac, *Tpan, *Taa;
static const int32_t *Tscf_partitions; /* [3][28] */
static int32_t Ttabs_len;

void mp3s_init_tables(
    const int32_t *tabs, int32_t tabs_len, const int32_t *tab32,
    const int32_t *tab33, const int32_t *tabindex, const int32_t *linbits,
    const double *pow43, const int32_t *scf_long, const int32_t *scf_short,
    const int32_t *scf_mixed, const int32_t *scf_partitions,
    const int32_t *scfc_decode, const int32_t *mod, const int32_t *preamp,
    const double *expfrac, const double *pan, const double *aa)
{
    Ttabs = tabs; Ttabs_len = tabs_len; Ttab32 = tab32; Ttab33 = tab33;
    Ttabindex = tabindex; Tlinbits = linbits; Tpow43 = pow43;
    Tscf_long = scf_long; Tscf_short = scf_short; Tscf_mixed = scf_mixed;
    Tscf_partitions = scf_partitions; Tscfc_decode = scfc_decode;
    Tmod = mod; Tpreamp = preamp; Texpfrac = expfrac; Tpan = pan; Taa = aa;
}

/* ------------------------------------------------------------------ */
/* header helpers (formats/mp3.py hdr_*) */
static int h_is_mono(const uint8_t *h)      { return (h[3] & 0xC0) == 0xC0; }
static int h_is_ms(const uint8_t *h)        { return (h[3] & 0xE0) == 0x60; }
static int h_is_free(const uint8_t *h)      { return (h[2] & 0xF0) == 0; }
static int h_is_crc(const uint8_t *h)       { return !(h[1] & 1); }
static int h_pad(const uint8_t *h)          { return h[2] & 0x2; }
static int h_mpeg1(const uint8_t *h)        { return h[1] & 0x8; }
static int h_not25(const uint8_t *h)        { return h[1] & 0x10; }
static int h_istereo(const uint8_t *h)      { return h[3] & 0x10; }
static int h_msstereo(const uint8_t *h)     { return h[3] & 0x20; }
static int h_layer(const uint8_t *h)        { return (h[1] >> 1) & 3; }
static int h_bitrate(const uint8_t *h)      { return h[2] >> 4; }
static int h_srate(const uint8_t *h)        { return (h[2] >> 2) & 3; }
static int h_my_srate(const uint8_t *h) {
    return h_srate(h) + (((h[1] >> 3) & 1) + ((h[1] >> 4) & 1)) * 3;
}
static int h_frame576(const uint8_t *h)     { return (h[1] & 14) == 2; }
static int h_layer1(const uint8_t *h)       { return (h[1] & 6) == 6; }

static const int HALFRATE[2][3][15] = {
    {{0,4,8,12,16,20,24,28,32,40,48,56,64,72,80},
     {0,4,8,12,16,20,24,28,32,40,48,56,64,72,80},
     {0,16,24,28,32,40,48,56,64,72,80,88,96,112,128}},
    {{0,16,20,24,28,32,40,48,56,64,80,96,112,128,160},
     {0,16,24,28,32,40,48,56,64,80,96,112,128,160,192},
     {0,16,32,48,64,80,96,112,128,144,160,176,192,208,224}},
};

static int h_kbps(const uint8_t *h) {
    return 2 * HALFRATE[h_mpeg1(h) ? 1 : 0][h_layer(h) - 1][h_bitrate(h)];
}

static int h_hz(const uint8_t *h) {
    static const int base[3] = {44100, 48000, 32000};
    int hz = base[h_srate(h)];
    if (!h_mpeg1(h)) hz >>= 1;
    if (!h_not25(h)) hz >>= 1;
    return hz;
}

static int h_frame_samples(const uint8_t *h) {
    if (h_layer1(h)) return 384;
    return 1152 >> (h_frame576(h) ? 1 : 0);
}

static int h_frame_bytes(const uint8_t *h, int free_format_size) {
    int fb = (int)((int64_t)h_frame_samples(h) * h_kbps(h) * 125 / h_hz(h));
    if (h_layer1(h)) fb &= ~3;
    return fb ? fb : free_format_size;
}

static int h_padding(const uint8_t *h) {
    if (h_pad(h)) return h_layer1(h) ? 4 : 1;
    return 0;
}

static int h_valid(const uint8_t *h) {
    return h[0] == 0xFF
        && (((h[1] & 0xF0) == 0xF0) || ((h[1] & 0xFE) == 0xE2))
        && h_layer(h) != 0 && h_bitrate(h) != 15 && h_srate(h) != 3;
}

static int h_compare(const uint8_t *h1, const uint8_t *h2) {
    return h_valid(h2)
        && ((h1[1] ^ h2[1]) & 0xFE) == 0
        && ((h1[2] ^ h2[2]) & 0x0C) == 0
        && !(h_is_free(h1) ^ h_is_free(h2));
}

/* ------------------------------------------------------------------ */
/* MSB-first bit reader (formats/mp3.py Bits) */
typedef struct { const uint8_t *buf; int64_t buflen, pos, limit; } bits_t;

static uint32_t bits_get(bits_t *b, int n) {
    int s = (int)(b->pos & 7);
    int shl = n + s;
    int64_t p = b->pos >> 3;
    uint32_t cache = 0, nxt;
    b->pos += n;
    if (b->pos > b->limit) return 0;
    nxt = (p < b->buflen ? b->buf[p] : 0) & (255u >> s);
    p++;
    while (shl - 8 > 0) {
        shl -= 8;
        cache |= nxt << shl;
        nxt = p < b->buflen ? b->buf[p] : 0;
        p++;
    }
    shl -= 8;
    return cache | (nxt >> -shl);
}

/* ------------------------------------------------------------------ */
/* frame sync (formats/mp3.py match_frame / find_frame) */
static int match_frame(const uint8_t *data, int64_t off, int64_t nbytes,
                       int frame_bytes) {
    int64_t i = 0;
    for (int nm = 0; nm < MAX_FRAME_SYNC_MATCHES; nm++) {
        i += h_frame_bytes(data + off + i, frame_bytes)
           + h_padding(data + off + i);
        if (i + HDR_SIZE > nbytes) return 1;
        if (!h_compare(data + off, data + off + i)) return 0;
    }
    return 1;
}

static int64_t find_frame(const uint8_t *data, int64_t n,
                          int *free_format_bytes, int *frame_size) {
    for (int64_t i = 0; i + HDR_SIZE <= n; i++) {
        const uint8_t *h = data + i;
        if (!h_valid(h)) continue;
        {
            int frame_bytes = h_frame_bytes(h, free_format_bytes[0]);
            int64_t frame_and_padding = frame_bytes + h_padding(h);
            int64_t k = HDR_SIZE;
            while (!frame_bytes && k < MAX_FREE_FORMAT_FRAME_SIZE
                   && i + 2 * k < n - HDR_SIZE) {
                if (h_compare(h, data + i + k)) {
                    int fb = (int)(k - h_padding(h));
                    int nextfb = fb + h_padding(data + i + k);
                    if (i + k + nextfb + HDR_SIZE <= n
                        && h_compare(h, data + i + k + nextfb)) {
                        frame_and_padding = k;
                        frame_bytes = fb;
                        free_format_bytes[0] = fb;
                    }
                }
                k++;
            }
            if ((frame_bytes && i + frame_and_padding <= n
                 && match_frame(data, i, n - i, frame_bytes))
                || (i == 0 && frame_and_padding == n)) {
                *frame_size = (int)frame_and_padding;
                return i;
            }
            free_format_bytes[0] = 0;
        }
    }
    *frame_size = 0;
    return n;
}

/* ------------------------------------------------------------------ */
/* side info (formats/mp3.py read_side_info) */
typedef struct {
    const int32_t *sfbtab;
    int part_23_length, big_values, scalefac_compress, global_gain;
    int block_type, mixed_block_flag, n_long_sfb, n_short_sfb;
    int32_t table_select[3], region_count[3], subblock_gain[3];
    int preflag, scalefac_scale, count1_table, scfsi;
} grinfo_t;

static int read_side_info(bits_t *bs, const uint8_t *hdr, grinfo_t *grs,
                          int *main_data_begin_out, int *gr_count_out) {
    int sr_idx = h_my_srate(hdr);
    int gr_count, main_data_begin, part_23_sum = 0;
    unsigned scfsi = 0;
    if (sr_idx != 0) sr_idx--;
    gr_count = h_is_mono(hdr) ? 1 : 2;
    if (h_mpeg1(hdr)) {
        gr_count *= 2;
        main_data_begin = bits_get(bs, 9);
        scfsi = bits_get(bs, 7 + gr_count);
    } else {
        main_data_begin = bits_get(bs, 8 + gr_count) >> gr_count;
    }
    for (int g = 0; g < gr_count; g++) {
        grinfo_t *gr = grs + g;
        unsigned tables;
        if (h_is_mono(hdr)) scfsi <<= 4;
        gr->part_23_length = bits_get(bs, 12);
        part_23_sum += gr->part_23_length;
        gr->big_values = bits_get(bs, 9);
        if (gr->big_values > 288) return -1;
        gr->global_gain = bits_get(bs, 8);
        gr->scalefac_compress = bits_get(bs, h_mpeg1(hdr) ? 4 : 9);
        gr->sfbtab = Tscf_long + sr_idx * 23;
        gr->n_long_sfb = 22;
        gr->n_short_sfb = 0;
        gr->region_count[0] = 0; gr->region_count[1] = 0;
        gr->region_count[2] = 255;
        gr->subblock_gain[0] = gr->subblock_gain[1] =
            gr->subblock_gain[2] = 0;
        if (bits_get(bs, 1)) {
            gr->block_type = bits_get(bs, 2);
            if (!gr->block_type) return -1;
            gr->mixed_block_flag = bits_get(bs, 1);
            gr->region_count[0] = 7;
            gr->region_count[1] = 255;
            if (gr->block_type == SHORT_BLOCK_TYPE) {
                scfsi &= 0x0F0F;
                if (!gr->mixed_block_flag) {
                    gr->region_count[0] = 8;
                    gr->sfbtab = Tscf_short + sr_idx * 40;
                    gr->n_long_sfb = 0;
                    gr->n_short_sfb = 39;
                } else {
                    gr->sfbtab = Tscf_mixed + sr_idx * 40;
                    gr->n_long_sfb = h_mpeg1(hdr) ? 8 : 6;
                    gr->n_short_sfb = 30;
                }
            }
            tables = bits_get(bs, 10) << 5;
            gr->subblock_gain[0] = bits_get(bs, 3);
            gr->subblock_gain[1] = bits_get(bs, 3);
            gr->subblock_gain[2] = bits_get(bs, 3);
        } else {
            gr->block_type = 0;
            gr->mixed_block_flag = 0;
            tables = bits_get(bs, 15);
            gr->region_count[0] = bits_get(bs, 4);
            gr->region_count[1] = bits_get(bs, 3);
            gr->region_count[2] = 255;
        }
        gr->table_select[0] = (tables >> 10) & 31;
        gr->table_select[1] = (tables >> 5) & 31;
        gr->table_select[2] = tables & 31;
        gr->preflag = h_mpeg1(hdr) ? (int)bits_get(bs, 1)
                                   : (gr->scalefac_compress >= 500);
        gr->scalefac_scale = bits_get(bs, 1);
        gr->count1_table = bits_get(bs, 1);
        gr->scfsi = (scfsi >> 12) & 15;
        scfsi = (scfsi << 4) & 0xFFFFFFFFu;
    }
    if (part_23_sum + bs->pos > bs->limit + (int64_t)main_data_begin * 8)
        return -1;
    *main_data_begin_out = main_data_begin;
    *gr_count_out = gr_count;
    return 0;
}

/* ------------------------------------------------------------------ */
/* scalefactors (formats/mp3.py decode_scalefactors) */
static double ldexp_q2(double y, int exp_q2) {
    for (;;) {
        int e = exp_q2 < 120 ? exp_q2 : 120;
        y *= ldexp(Texpfrac[e & 3], 30 - (e >> 2));
        exp_q2 -= e;
        if (exp_q2 <= 0) return y;
    }
}

static void read_scalefactors(uint8_t *ist_pos, const int *scf_size,
                              const int32_t *scf_count, bits_t *bs,
                              int scfsi, int *iscf, int *n_read) {
    int pos = 0, ni = 0;
    for (int i = 0; i < 4; i++) {
        int cnt = scf_count[i];
        if (cnt == 0) break;
        if (scfsi & 8) {
            for (int k = 0; k < cnt; k++) iscf[ni++] = ist_pos[pos + k];
        } else {
            int bits = scf_size[i];
            if (bits == 0) {
                for (int k = 0; k < cnt; k++) {
                    ist_pos[pos + k] = 0;
                    iscf[ni++] = 0;
                }
            } else {
                int max_scf = scfsi < 0 ? (1 << bits) - 1 : -1;
                for (int k = 0; k < cnt; k++) {
                    int s = (int)bits_get(bs, bits);
                    ist_pos[pos + k] = (uint8_t)(s == max_scf ? 255 : s);
                    iscf[ni++] = s;
                }
            }
        }
        pos += cnt;
        scfsi *= 2;
    }
    iscf[ni] = iscf[ni + 1] = iscf[ni + 2] = 0;
    *n_read = ni;
}

static void decode_scalefactors(const uint8_t *hdr, uint8_t *ist_pos,
                                bits_t *bs, const grinfo_t *gr, int ch,
                                double *scf /* [40] */) {
    const int32_t *scf_partition = Tscf_partitions
        + 28 * ((gr->n_short_sfb ? 1 : 0) + (gr->n_long_sfb ? 0 : 1));
    int scf_size[4] = {0, 0, 0, 0};
    int iscf[48];
    int scf_shift = gr->scalefac_scale + 1;
    int scfsi = gr->scfsi;
    int part_off = 0, n_read = 0;
    memset(iscf, 0, sizeof iscf);
    if (h_mpeg1(hdr)) {
        int part = Tscfc_decode[gr->scalefac_compress];
        scf_size[0] = scf_size[1] = part >> 2;
        scf_size[2] = scf_size[3] = part & 3;
    } else {
        int ist = (h_istereo(hdr) && ch) ? 1 : 0;
        int sfc = gr->scalefac_compress >> ist;
        int k = ist * 3 * 4;
        while (sfc >= 0) {
            int modprod = 1;
            for (int i = 3; i >= 0; i--) {
                scf_size[i] = (sfc / modprod) % Tmod[k + i];
                modprod *= Tmod[k + i];
            }
            sfc -= modprod;
            k += 4;
        }
        part_off = k;
        scfsi = -16;
    }
    read_scalefactors(ist_pos, scf_size, scf_partition + part_off, bs,
                      scfsi, iscf, &n_read);
    if (gr->n_short_sfb) {
        int sh = 3 - scf_shift;
        for (int i = 0; i < gr->n_short_sfb; i += 3) {
            iscf[gr->n_long_sfb + i + 0] += gr->subblock_gain[0] << sh;
            iscf[gr->n_long_sfb + i + 1] += gr->subblock_gain[1] << sh;
            iscf[gr->n_long_sfb + i + 2] += gr->subblock_gain[2] << sh;
        }
    } else if (gr->preflag) {
        for (int i = 0; i < 10; i++) iscf[11 + i] += Tpreamp[i];
    }
    {
        int gain_exp = gr->global_gain - 4 - 210
                       - (h_is_ms(hdr) ? 2 : 0);
        double gain = ldexp_q2((double)(1 << (MAX_SCFI / 4)),
                               MAX_SCFI - gain_exp);
        int n = gr->n_long_sfb + gr->n_short_sfb;
        for (int i = 0; i < 40; i++) scf[i] = 0.0;
        for (int i = 0; i < n; i++)
            scf[i] = ldexp_q2(gain, iscf[i] << scf_shift);
    }
}

/* ------------------------------------------------------------------ */
/* stereo / reorder / antialias (formats/mp3.py) */
static void midside_stereo(float *l, float *r, int n) {
    for (int i = 0; i < n; i++) {
        float a = l[i], b = r[i];
        l[i] = a + b;
        r[i] = a - b;
    }
}

static void stereo_top_band(const float *right, const int32_t *sfb,
                            int nbands, int *max_band) {
    int pos = 0;
    max_band[0] = max_band[1] = max_band[2] = -1;
    for (int i = 0; i < nbands; i++) {
        int ln = sfb[i];
        for (int k = 0; k < ln; k += 2) {
            if (right[pos + k] != 0 || right[pos + k + 1] != 0) {
                max_band[i % 3] = i;
                break;
            }
        }
        pos += ln;
    }
}

static void stereo_process(float *l, float *r, const uint8_t *ist_pos,
                           const int32_t *sfb, const uint8_t *hdr,
                           const int *max_band, int mpeg2_sh) {
    int max_pos = h_mpeg1(hdr) ? 7 : 64;
    int pos = 0;
    for (int i = 0; sfb[i]; i++) {
        int ipos = ist_pos[i];
        int ln = sfb[i];
        if (i > max_band[i % 3] && ipos < max_pos) {
            double kl, kr;
            double s = h_msstereo(hdr) ? sqrt(2.0) : 1.0;
            if (h_mpeg1(hdr)) {
                kl = Tpan[2 * ipos];
                kr = Tpan[2 * ipos + 1];
            } else {
                kl = 1.0;
                kr = ldexp_q2(1.0, ((ipos + 1) >> 1) << mpeg2_sh);
                if (ipos & 1) { kl = kr; kr = 1.0; }
            }
            for (int k = 0; k < ln; k++) {
                float left = l[pos + k];
                r[pos + k] = (float)(left * (kr * s));
                l[pos + k] = (float)(left * (kl * s));
            }
        } else if (h_msstereo(hdr)) {
            midside_stereo(l + pos, r + pos, ln);
        }
        pos += ln;
    }
}

static void intensity_stereo(float *l, float *r, uint8_t *ist_pos,
                             const grinfo_t *gr_pair, const uint8_t *hdr) {
    const grinfo_t *gr = gr_pair;
    int n_sfb = gr->n_long_sfb + gr->n_short_sfb;
    int max_blocks = gr->n_short_sfb ? 3 : 1;
    int max_band[3];
    stereo_top_band(r, gr->sfbtab, n_sfb, max_band);
    if (gr->n_long_sfb) {
        int mb = max_band[0];
        if (max_band[1] > mb) mb = max_band[1];
        if (max_band[2] > mb) mb = max_band[2];
        max_band[0] = max_band[1] = max_band[2] = mb;
    }
    for (int i = 0; i < max_blocks; i++) {
        int default_pos = h_mpeg1(hdr) ? 3 : 0;
        int itop = n_sfb - max_blocks + i;
        int prev = itop - max_blocks;
        ist_pos[itop] = (uint8_t)(max_band[i] >= prev ? default_pos
                                                      : ist_pos[prev]);
    }
    stereo_process(l, r, ist_pos, gr->sfbtab, hdr, max_band,
                   gr_pair[1].scalefac_compress & 1);
}

static void reorder(float *grbuf, int offset, const int32_t *sfb) {
    float dst[576];
    int nd = 0;
    int src = offset;
    for (int i = 0; sfb[i]; i += 3) {
        int ln = sfb[i];
        for (int k = 0; k < ln; k++) {
            dst[nd++] = grbuf[src + k + 0 * ln];
            dst[nd++] = grbuf[src + k + 1 * ln];
            dst[nd++] = grbuf[src + k + 2 * ln];
        }
        src += 3 * ln;
    }
    memcpy(grbuf + offset, dst, nd * sizeof(float));
}

static void antialias(float *grbuf, int nbands) {
    for (int b = 0; b < nbands; b++) {
        float *g = grbuf + 18 * b;
        for (int i = 0; i < 8; i++) {
            float u = g[18 + i];
            float d = g[17 - i];
            g[18 + i] = (float)(u * Taa[i] - d * Taa[8 + i]);
            g[17 - i] = (float)(u * Taa[8 + i] + d * Taa[i]);
        }
    }
}

/* ------------------------------------------------------------------ */
/* decoder state carried by the caller across calls */
typedef struct {
    uint8_t header[4];
    int32_t reserv;
    int32_t free_format_bytes;
    uint8_t reserv_buf[MAX_BITRESERVOIR_BYTES];
} mp3s_state;

/* result flags */
#define MP3S_EOF 0
#define MP3S_RESET 1        /* decoder re-synced: caller flushes segment */
#define MP3S_PARAMS 2       /* channels/hz changed: caller flushes */
#define MP3S_FULL 3         /* maxG reached: caller extends, no flush */
#define MP3S_FALLBACK 4     /* not Layer III / free format: caller's frame loop */

/* Decode Layer-III granules until an event. Returns granule count
 * written to grbufs [maxG][2][576] / kinds [maxG][2][32]. */
int64_t mp3s_l3_stream(
    const uint8_t *data, int64_t len, int64_t *pos_io, mp3s_state *st,
    float *grbufs, int8_t *kinds, int32_t *info /* {channels, hz} */,
    int64_t maxG, int32_t pending /* caller holds unflushed granules */,
    int32_t *flag)
{
    int64_t pos = *pos_io;
    int64_t G = 0;
    uint8_t maindata[MAX_BITRESERVOIR_BYTES + 2880 + 8];
    int channels0 = info[0] ? info[0] : 0, hz0 = info[1] ? info[1] : 0;

    while (pos + HDR_SIZE <= len) {
        const uint8_t *d = data + pos;
        int64_t avail = len - pos;
        int frame_size = 0;
        int64_t i = 0;

        if (avail > 4 && st->header[0] == 0xFF
            && h_compare(st->header, d)) {
            frame_size = h_frame_bytes(d, st->free_format_bytes)
                       + h_padding(d);
            if (frame_size != avail
                && (frame_size + HDR_SIZE > avail
                    || !h_compare(d, d + frame_size))) {
                frame_size = 0;
            }
        }
        if (!frame_size) {
            /* resync: the decoder resets here (a new segment). The
             * state is cleared BEFORE returning so the next call (after
             * the caller flushed) re-enters this branch and makes
             * progress via find_frame. */
            memset(st->header, 0, 4);
            st->reserv = 0;
            if (G > 0 || pending) { *flag = MP3S_RESET; goto out; }
            {
                int ffb = st->free_format_bytes = 0;
                int fs = 0;
                i = find_frame(d, avail, &ffb, &fs);
                st->free_format_bytes = ffb;
                frame_size = fs;
                if (!frame_size || i + frame_size > avail) {
                    *flag = MP3S_EOF;
                    pos += i;
                    goto out;
                }
            }
        }

        {
            const uint8_t *hdr = d + i;
            int channels = h_is_mono(hdr) ? 1 : 2;
            int hz = h_hz(hdr);
            int layer = 4 - h_layer(hdr);
            bits_t bs;
            int main_data_begin, gr_count;
            grinfo_t grs[4];

            if (layer != 3 || h_is_free(hdr)) {
                *flag = MP3S_FALLBACK;
                pos += i;         /* frame start: the caller takes over here */
                goto out;
            }
            if ((channels0 && channels != channels0)
                || (hz0 && hz != hz0)) {
                if (G > 0) { *flag = MP3S_PARAMS; goto out; }
                channels0 = 0;
                hz0 = 0;
            }
            memcpy(st->header, hdr, 4);

            bs.buf = hdr + HDR_SIZE;
            bs.buflen = frame_size - HDR_SIZE;
            bs.pos = 0;
            bs.limit = bs.buflen * 8;
            if (h_is_crc(hdr)) bits_get(&bs, 16);

            if (read_side_info(&bs, hdr, grs, &main_data_begin,
                               &gr_count) != 0) {
                /* reset + consume the frame (a new segment: caller flushes) */
                memset(st->header, 0, 4);
                st->reserv = 0;
                st->free_format_bytes = 0;
                pos += i + frame_size;
                if (G > 0 || pending) { *flag = MP3S_RESET; goto out; }
                continue;
            }

            {
                int64_t frame_bytes = (bs.limit - bs.pos) / 8;
                int bytes_have = st->reserv < main_data_begin
                               ? st->reserv : main_data_begin;
                int from = st->reserv - main_data_begin;
                int success = st->reserv >= main_data_begin;
                int64_t md_len;
                bits_t mbs;
                if (from < 0) from = 0;
                memcpy(maindata, st->reserv_buf + from, bytes_have);
                memcpy(maindata + bytes_have, bs.buf + bs.pos / 8,
                       frame_bytes);
                md_len = bytes_have + frame_bytes;
                mbs.buf = maindata;
                mbs.buflen = md_len;
                mbs.pos = 0;
                mbs.limit = md_len * 8;

                if (success) {
                    int ngr = h_mpeg1(hdr) ? 2 : 1;
                    uint8_t ist_pos[2][40];
                    memset(ist_pos, 0, sizeof ist_pos);
                    for (int igr = 0; igr < ngr; igr++) {
                        const grinfo_t *gp = grs + igr * channels;
                        float *gb = grbufs + (G) * 2 * 576;
                        int8_t *kd = kinds + (G) * 2 * 32;
                        double scf_store[2][40];
                        memset(gb, 0, 2 * 576 * sizeof(float));
                        for (int ch = 0; ch < channels; ch++) {
                            int64_t limit = mbs.pos
                                          + gp[ch].part_23_length;
                            decode_scalefactors(hdr, ist_pos[ch], &mbs,
                                                gp + ch, ch,
                                                scf_store[ch]);
                            mp3_l3_huffman(
                                gb + ch * 576, mbs.buf, mbs.buflen,
                                mbs.pos, Ttabs, Ttab32, Ttab33,
                                Ttabindex, Tlinbits, Tpow43,
                                gp[ch].sfbtab, scf_store[ch],
                                gp[ch].big_values, gp[ch].table_select,
                                gp[ch].region_count, gp[ch].count1_table,
                                limit, Ttabs_len);
                            mbs.pos = limit;
                        }
                        if (h_istereo(hdr)) {
                            intensity_stereo(gb, gb + 576, ist_pos[1],
                                             gp, hdr);
                        } else if (h_is_ms(hdr)) {
                            midside_stereo(gb, gb + 576, 576);
                        }
                        for (int ch = 0; ch < channels; ch++) {
                            const grinfo_t *gr = gp + ch;
                            int aa_bands = 31;
                            int n_long = (gr->mixed_block_flag ? 2 : 0)
                                << (h_my_srate(hdr) == 2 ? 1 : 0);
                            if (gr->n_short_sfb) {
                                aa_bands = n_long - 1;
                                reorder(gb + ch * 576, n_long * 18,
                                        gr->sfbtab + gr->n_long_sfb);
                            }
                            antialias(gb + ch * 576, aa_bands);
                            /* band kinds (ops/mp3_synth.py band_kinds) */
                            {
                                int8_t base = gr->block_type == 2 ? 2
                                    : (gr->block_type == 3 ? 1 : 0);
                                for (int b = 0; b < 32; b++)
                                    kd[ch * 32 + b] =
                                        b < n_long ? 0 : base;
                            }
                        }
                        G++;
                    }
                    channels0 = channels;
                    hz0 = hz;
                    info[0] = channels;
                    info[1] = hz;
                }

                /* save reservoir */
                {
                    int64_t p = (mbs.pos + 7) / 8;
                    int64_t remains = mbs.limit / 8 - p;
                    if (remains > MAX_BITRESERVOIR_BYTES) {
                        p += remains - MAX_BITRESERVOIR_BYTES;
                        remains = MAX_BITRESERVOIR_BYTES;
                    }
                    if (remains > 0)
                        memmove(st->reserv_buf, maindata + p, remains);
                    st->reserv = remains > 0 ? (int32_t)remains : 0;
                }
            }
            pos += i + frame_size;
            if (G + 2 > maxG) { *flag = MP3S_FULL; goto out; }
        }
    }
    *flag = MP3S_EOF;
out:
    *pos_io = pos;
    return G;
}
