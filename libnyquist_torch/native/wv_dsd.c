/* WavPack DSD block decode (modes 0 / 1 / 3).
 *
 * PROVENANCE: bit-exact reimplementation of the WavPack DSD bitstream
 * (reference: third_party/wavpack/src/unpack_dsd.c — init_dsd_block,
 * decode_fast, decode_high, init_ptable).  The format is defined only
 * by that implementation (no external spec), so the arithmetic-coder
 * state machine and adaptive filter recurrences are necessarily
 * isomorphic; this file restyles them around an explicit state struct
 * with int64-free uint32 range arithmetic and adds the bound checks
 * the repo's fuzz policy requires.  The reference's own CMake never
 * defines ENABLE_DSD, so this plane is validated against a standalone
 * build of the reference library (tools/gen_dsd_wv.c).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define DSD_MAX_HISTORY_BITS 5

typedef struct {
    const uint8_t *ptr, *end;
    uint32_t low, high, value;
} DsdRange;

static int range_init (DsdRange *rc, const uint8_t *ptr, const uint8_t *end)
{
    int i;

    rc->ptr = ptr;
    rc->end = end;
    rc->low = 0;
    rc->high = 0xffffffff;
    rc->value = 0;
    if (end - ptr < 4)
        return -1;
    for (i = 0; i < 4; i++)
        rc->value = (rc->value << 8) | *rc->ptr++;
    return 0;
}

static void range_shift (DsdRange *rc)
{
    /* renormalize whenever the top byte of low/high agree */
    while (!(((rc->high ^ rc->low) & 0xff000000)) && rc->ptr < rc->end) {
        rc->value = (rc->value << 8) | *rc->ptr++;
        rc->high = (rc->high << 8) | 0xff;
        rc->low <<= 8;
    }
}

/* ---------------- mode 1: per-byte value-table arithmetic coder ----- */

static int64_t decode_fast_mode (const uint8_t *data, int64_t len,
                                 int stereo, int64_t total,
                                 uint8_t *out)
{
    const uint8_t *ptr = data, *end = data + len;
    int bins, i, b;
    uint8_t history_bits, max_prob;
    uint8_t *prob = NULL, **lookup = NULL;
    int32_t *summed = NULL;
    int64_t n, total_summed = 0;
    int p0 = 0, p1 = 0;
    DsdRange rc;
    int64_t rv = -1;

    if (end - ptr < 2)
        return -1;
    history_bits = *ptr++;
    if (history_bits > DSD_MAX_HISTORY_BITS)
        return -1;
    bins = 1 << history_bits;

    prob = calloc ((size_t) bins, 256);
    summed = calloc ((size_t) bins, 256 * sizeof (int32_t));
    lookup = calloc ((size_t) bins, sizeof (uint8_t *));
    if (!prob || !summed || !lookup)
        goto done;

    max_prob = *ptr++;

    if (max_prob < 0xff) {
        /* RLE plane: code > max_prob encodes a zero run, 0 terminates */
        uint8_t *op = prob, *oe = prob + (size_t) bins * 256;

        while (op < oe && ptr < end) {
            int code = *ptr++;

            if (code > max_prob) {
                int zrun = code - max_prob;

                while (op < oe && zrun--)
                    *op++ = 0;
            }
            else if (code)
                *op++ = (uint8_t) code;
            else
                break;
        }
        if (op < oe || (ptr < end && *ptr++))
            goto done;
    }
    else if (end - ptr > (int64_t) bins * 256) {
        memcpy (prob, ptr, (size_t) bins * 256);
        ptr += (size_t) bins * 256;
    }
    else
        goto done;

    for (b = 0; b < bins; b++) {
        int32_t sum = 0;

        for (i = 0; i < 256; i++)
            summed [b * 256 + i] = sum += prob [b * 256 + i];

        /* the reference stores sums in int16; any bin overflowing that
         * is malformed (its encoder never emits one) — reject instead
         * of wrapping */
        if (sum > 32767)
            goto done;

        if (sum) {
            uint8_t *vp;

            total_summed += sum;
            vp = lookup [b] = malloc ((size_t) sum);
            if (!vp)
                goto done;
            for (i = 0; i < 256; i++) {
                int c = prob [b * 256 + i];

                while (c--)
                    *vp++ = (uint8_t) i;
            }
        }
    }

    if (total_summed > (int64_t) bins * 1280)
        goto done;
    if (range_init (&rc, ptr, end))
        goto done;

    for (n = 0; n < total; n++) {
        int32_t sum = summed [p0 * 256 + 255];
        uint32_t mult, index;
        int code;

        if (!sum)
            goto done;
        mult = (rc.high - rc.low) / (uint32_t) sum;
        if (!mult) {
            if (rc.end - rc.ptr >= 4)
                for (i = 0; i < 4; i++)
                    rc.value = (rc.value << 8) | *rc.ptr++;
            rc.low = 0;
            rc.high = 0xffffffff;
            mult = rc.high / (uint32_t) sum;
            if (!mult)
                goto done;
        }
        index = (rc.value - rc.low) / mult;
        if (index >= (uint32_t) sum)
            goto done;
        code = lookup [p0] [index];
        if (code)
            rc.low += (uint32_t) summed [p0 * 256 + code - 1] * mult;
        rc.high = rc.low + (uint32_t) prob [p0 * 256 + code] * mult - 1;
        out [n] = (uint8_t) code;

        if (!stereo)
            p0 = code & (bins - 1);
        else {
            p0 = p1;
            p1 = code & (bins - 1);
        }
        range_shift (&rc);
    }
    rv = total;

done:
    if (lookup) {
        for (b = 0; b < bins; b++)
            free (lookup [b]);
        free (lookup);
    }
    free (prob);
    free (summed);
    return rv;
}

/* ---------------- mode 3: per-bit adaptive filter coder ------------- */

#define PT_BITS 8
#define PT_BINS (1 << PT_BITS)
#define PT_MASK (PT_BINS - 1)
#define PT_UP 0x010000fe
#define PT_DOWN 0x00010000
#define PT_DECAY 8
#define DSD_PRECISION 20
#define DSD_VALUE_ONE (1 << DSD_PRECISION)
#define DSD_PRECISION_USE 12
#define DSD_RATE_S 20

typedef struct {
    int32_t f0, f1, f2, f3, f4, f5, f6;
    int32_t factor, byte, value;
} DsdFilter;

static void build_ptable (int32_t *table, int rate_i, int rate_s)
{
    int32_t value = 0x808000, rate = rate_i << 8;
    int c, i;

    for (c = (rate + 128) >> 8; c--;)
        value += (PT_DOWN - value) >> PT_DECAY;

    for (i = 0; i < PT_BINS / 2; i++) {
        table [i] = value;
        table [PT_BINS - 1 - i] = 0x100ffff - value;

        if (value > 0x010000) {
            rate += (rate * rate_s + 128) >> 8;
            for (c = (rate + 64) >> 7; c--;)
                value += (PT_DOWN - value) >> PT_DECAY;
        }
    }
}

static void filter_bit (DsdFilter *f, DsdRange *rc, int32_t *ptable)
{
    int32_t *pp = ptable + ((f->value >> (DSD_PRECISION - DSD_PRECISION_USE))
                            & PT_MASK);
    uint32_t split = rc->low + ((rc->high - rc->low) >> 8)
        * (uint32_t) (*pp >> 16);

    if (rc->value <= split) {
        rc->high = split;
        *pp += (PT_UP - *pp) >> PT_DECAY;
        f->f0 = -1;
    }
    else {
        rc->low = split + 1;
        *pp += (PT_DOWN - *pp) >> PT_DECAY;
        f->f0 = 0;
    }
    range_shift (rc);

    f->value += f->f6 << 3;
    f->byte = (f->byte << 1) | (f->f0 & 1);
    f->factor += (((f->value ^ f->f0) >> 31) | 1)
        & ((f->value ^ (f->value - (f->f6 << 4))) >> 31);
    f->f1 += ((f->f0 & DSD_VALUE_ONE) - f->f1) >> 6;
    f->f2 += ((f->f0 & DSD_VALUE_ONE) - f->f2) >> 4;
    f->f3 += (f->f2 - f->f3) >> 4;
    f->f4 += (f->f3 - f->f4) >> 4;
    f->value = (f->f4 - f->f5) >> 4;
    f->f5 += f->value;
    f->f6 += (f->value - f->f6) >> 3;
    f->value = f->f1 - f->f5 + ((f->f6 * f->factor) >> 2);
}

static int64_t decode_high_mode (const uint8_t *data, int64_t len,
                                 int stereo, int64_t nframes,
                                 uint8_t *out)
{
    const uint8_t *ptr = data, *end = data + len;
    int32_t ptable [PT_BINS];
    DsdFilter filt [2];
    int nch = stereo ? 2 : 1, ch, rate_i, rate_s;
    int64_t n;
    DsdRange rc;

    if (end - ptr < (stereo ? 20 : 13))
        return -1;

    rate_i = *ptr++;
    rate_s = *ptr++;
    if (rate_s != DSD_RATE_S)
        return -1;
    build_ptable (ptable, rate_i, rate_s);

    memset (filt, 0, sizeof (filt));
    for (ch = 0; ch < nch; ch++) {
        DsdFilter *f = filt + ch;

        f->f1 = *ptr++ << (DSD_PRECISION - 8);
        f->f2 = *ptr++ << (DSD_PRECISION - 8);
        f->f3 = *ptr++ << (DSD_PRECISION - 8);
        f->f4 = *ptr++ << (DSD_PRECISION - 8);
        f->f5 = *ptr++ << (DSD_PRECISION - 8);
        f->f6 = 0;
        f->factor = *ptr++ & 0xff;
        f->factor |= (*ptr++ << 8) & 0xff00;
        f->factor = (f->factor << 16) >> 16;
    }

    if (range_init (&rc, ptr, end))
        return -1;

    for (n = 0; n < nframes; n++) {
        int bit;

        filt [0].value = filt [0].f1 - filt [0].f5
            + ((filt [0].f6 * filt [0].factor) >> 2);
        if (stereo)
            filt [1].value = filt [1].f1 - filt [1].f5
                + ((filt [1].f6 * filt [1].factor) >> 2);

        for (bit = 0; bit < 8; bit++) {
            filter_bit (&filt [0], &rc, ptable);
            if (stereo)
                filter_bit (&filt [1], &rc, ptable);
        }

        out [n * nch] = (uint8_t) (filt [0].byte & 0xff);
        filt [0].factor -= (filt [0].factor + 512) >> 10;
        if (stereo) {
            out [n * nch + 1] = (uint8_t) (filt [1].byte & 0xff);
            filt [1].factor -= (filt [1].factor + 512) >> 10;
        }
    }
    return nframes;
}

/* ---------------- entry point ---------------------------------------
 * data/len: ID_DSD_BLOCK body AFTER the (power, mode) prefix bytes.
 * mode: 0 stored bytes, 1 fast, 3 high.  stereo: interleaved L/R.
 * nframes: byte frames per channel.  out: nframes * nch bytes.
 * Returns nframes, or -1 on malformed stream. */

int64_t wv_dsd_decode (const uint8_t *data, int64_t len, int mode,
                       int stereo, int64_t nframes, uint8_t *out)
{
    int64_t total = nframes * (stereo ? 2 : 1);

    if (nframes < 0)
        return -1;
    if (mode == 0) {
        if (len != total)
            return -1;
        memcpy (out, data, (size_t) total);
        return nframes;
    }
    if (mode == 1)
        return decode_fast_mode (data, len, stereo, total, out) < 0
            ? -1 : nframes;
    if (mode == 3)
        return decode_high_mode (data, len, stereo, nframes, out);
    return -1;
}
