/* Native MP3 Layer-3 Huffman decode, minimp3.h:742 L3_huffman
 * semantics: 32-bit peek/flush cache, multi-level codebook walk,
 * linbits escapes, count1 quads. Called per granule and channel by
 * mp3_stream.c.
 */
#include <stdint.h>
#include <math.h>

typedef struct {
    const uint8_t *buf;
    int64_t buflen;
    int64_t np_ptr;
    uint32_t cache;
    int sh;
} hbits;

static uint32_t h_peek(const hbits *h, int n) { return h->cache >> (32 - n); }

static void h_flush(hbits *h, int n) {
    h->cache <<= n;
    h->sh += n;
}

static void h_check(hbits *h) {
    while (h->sh >= 0) {
        uint32_t b = h->np_ptr < h->buflen ? h->buf[h->np_ptr] : 0;
        h->cache |= b << h->sh;
        h->np_ptr++;
        h->sh -= 8;
    }
}

static double h_pow43(const double *g_pow43, int x) {
    double frac;
    int sign, mult = 16;
    if (x < 129) return g_pow43[16 + x];
    if (x < 1024) x <<= 3;
    else mult = 256;
    sign = 2 * x & 64;
    frac = (double)((x & 63) - sign) / ((x & ~63) + sign);
    return g_pow43[16 + ((x + sign) >> 6)]
        * (1.0 + frac * ((4.0 / 3) + frac * (2.0 / 9))) * mult;
}

/* returns nothing; dst fully written for the granule's huffman part */
void mp3_l3_huffman(
    float *dst, const uint8_t *buf, int64_t buflen, int64_t pos_bits,
    const int32_t *tabs, const int32_t *tab32, const int32_t *tab33,
    const int32_t *tabindex, const int32_t *g_linbits,
    const double *g_pow43, const int32_t *sfb, const double *scf,
    int big_values, const int32_t *table_select,
    const int32_t *region_count, int count1_table, int64_t layer3gr_limit,
    int32_t tabs_len)
{
    hbits h;
    double one = 0.0;
    int ireg = 0, big_val_cnt = big_values;
    int sfb_i = 0, scf_i = 0, di = 0;
    int64_t p = pos_bits >> 3;

    h.buf = buf;
    h.buflen = buflen;
    h.cache = ((((uint32_t)buf[p] * 256u + buf[p + 1]) * 256u
                + buf[p + 2]) * 256u + buf[p + 3]) << (pos_bits & 7);
    h.sh = (int)(pos_bits & 7) - 8;
    h.np_ptr = p + 4;

    while (big_val_cnt > 0) {
        int tab_num = table_select[ireg];
        int sfb_cnt = region_count[ireg];
        int32_t cb_off = tabindex[tab_num];
        const int32_t *codebook = tabs + cb_off;
        int32_t cb_max = tabs_len - cb_off - 1;
        int linbits = g_linbits[tab_num];
        ireg++;
        for (;;) {
            int npairs = sfb[sfb_i++] / 2;
            int pairs_to_decode = big_val_cnt < npairs ? big_val_cnt : npairs;
            one = scf[scf_i++];
            for (;;) {
                int w = 5, j;
                if (di > 574) return;
                int64_t ci = h_peek(&h, w);
                int leaf = codebook[ci > cb_max ? cb_max : ci];
                while (leaf < 0) {
                    h_flush(&h, w);
                    w = leaf & 7;
                    ci = (int64_t)h_peek(&h, w) - (leaf >> 3);
                    if (ci < 0) ci = 0;
                    if (ci > cb_max) ci = cb_max;
                    leaf = codebook[ci];
                }
                h_flush(&h, leaf >> 8);
                for (j = 0; j < 2; j++) {
                    int lsb = leaf & 0x0F;
                    if (lsb == 15 && linbits) {
                        lsb += h_peek(&h, linbits);
                        h_flush(&h, linbits);
                        h_check(&h);
                        dst[di] = (float)(one * h_pow43(g_pow43, lsb)
                                  * ((h.cache & 0x80000000u) ? -1.0 : 1.0));
                    }
                    else {
                        dst[di] = (float)(g_pow43[
                            16 + lsb - 16 * (int)(h.cache >> 31)] * one);
                    }
                    h_flush(&h, lsb ? 1 : 0);
                    di++;
                    leaf >>= 4;
                }
                h_check(&h);
                if (--pairs_to_decode == 0) break;
            }
            big_val_cnt -= npairs;
            sfb_cnt--;
            if (!(big_val_cnt > 0 && sfb_cnt >= 0)) break;
        }
    }

    /* count1 quads */
    {
        int64_t npv = 1 - big_val_cnt;
        for (;;) {
            const int32_t *cb1 = count1_table ? tab33 : tab32;
            int leaf = cb1[h_peek(&h, 4)];
            int64_t bspos;
            int stop = 0, sslot;
            if (!(leaf & 8)) {
                int sh2 = 32 - (leaf & 3);
                uint32_t extra = sh2 < 32 ? ((h.cache << 4) >> sh2) : 0;
                int64_t ci = (leaf >> 3) + (int64_t)extra;
                int64_t cmax = count1_table ? 15 : 27;
                if (ci > cmax) ci = cmax;
                leaf = cb1[ci];
            }
            h_flush(&h, leaf & 7);
            bspos = h.np_ptr * 8 - 24 + h.sh;
            if (bspos > layer3gr_limit || di > 572) break;

            if (!--npv) {
                npv = sfb[sfb_i++] / 2;
                if (!npv) stop = 1;
                else one = scf[scf_i++];
            }
            if (stop) break;
            for (sslot = 0; sslot < 2; sslot++) {
                if (leaf & (128 >> sslot)) {
                    dst[di + sslot] = (float)(
                        (h.cache & 0x80000000u) ? -one : one);
                    h_flush(&h, 1);
                }
            }
            if (!--npv) {
                npv = sfb[sfb_i++] / 2;
                if (!npv) stop = 1;
                else one = scf[scf_i++];
            }
            if (stop) break;
            for (sslot = 2; sslot < 4; sslot++) {
                if (leaf & (128 >> sslot)) {
                    dst[di + sslot] = (float)(
                        (h.cache & 0x80000000u) ? -one : one);
                    h_flush(&h, 1);
                }
            }
            h_check(&h);
            di += 4;
        }
    }
}
