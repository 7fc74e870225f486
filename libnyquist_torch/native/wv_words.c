/* WavPack PCM entropy words, decorrelation passes and float restores
 * (the host half of formats/wavpack.py).
 *
 * Re-implementation of the WavPack 4/5 bitstream semantics (reference:
 * wavpack/src/read_words.c get_words_lossless, unpack.c
 * decorr_stereo_pass / decorr_mono_pass / unpack_samples,
 * unpack_floats.c float_values / float_values_nowvx).  Byte-serial,
 * branchy work that stays on the host; the card does the dense tail
 * (ops/lossless.py).
 *
 * Entries (all bound with full argtypes in runtime/native.py):
 *   wv_words_lossless, wv_words_hybrid   entropy words of one block
 *   wv_decorr_mono, wv_decorr_stereo     one decorrelation pass
 *   wv_decode_block                      words -> passes -> joint stereo
 *   wv_float_values, wv_float_nowvx      float bit restore
 */
#include <stdint.h>
#include <string.h>

/* 64-bit cached LSB-first reader.  Past-limit bits read as 1s — that is
 * WavPack's EOF mechanism (the ones_count==17 / cbits==33 escapes in the
 * words readers fire on the all-ones tail).  `pos` tracks the absolute
 * consumed bit position exactly; the words readers return it as the
 * resume point for the next block slice. */
typedef struct {
    const unsigned char *buf;
    uint64_t limit;     /* total valid bits */
    uint64_t bytepos;   /* next byte to load into the cache */
    uint64_t cache;     /* LSB-aligned pending bits */
    int ncache;
} wv_bits;

/* Absolute consumed bit position.  Invariant maintained by every read
 * primitive below: pos == bytepos*8 - ncache (refill adds 8 to both
 * sides; a read of k bits drops ncache by k).  Deriving it here keeps
 * a pos += k off every primitive's hot path. */
static inline uint64_t wv_tell(const wv_bits *b) {
    return (b->bytepos << 3) - (uint64_t)b->ncache;
}

static inline void wv_refill(wv_bits *b) {
    uint64_t nbytes = (b->limit + 7) >> 3;
    /* bulk fast path: all 8 loaded bytes fully inside the limit (no
     * partial tail byte to pad) — one unaligned 64-bit load replaces
     * up to 7 per-byte iterations.  Only whole bytes are committed, so
     * the cache invariant (bits >= ncache are zero) is kept by masking
     * the loaded chunk to exactly the committed width. */
    if (b->ncache <= 56 && b->bytepos + 8 <= (b->limit >> 3)) {
        uint64_t chunk;
        memcpy(&chunk, b->buf + b->bytepos, 8);
        int take = (64 - b->ncache) >> 3;          /* bytes, >= 1 */
        int width = take << 3;
        uint64_t mask = (width == 64) ? ~0ull : ((1ull << width) - 1);
        b->cache |= (chunk & mask) << b->ncache;
        b->bytepos += take;
        b->ncache += width;
        return;
    }
    while (b->ncache <= 56) {
        uint64_t byte;
        if (b->bytepos < nbytes) {
            byte = b->buf[b->bytepos];
            uint64_t bit0 = b->bytepos << 3;
            if (bit0 + 8 > b->limit)         /* partial tail byte: pad 1s */
                byte = (byte | (0xFFull << (b->limit - bit0))) & 0xFF;
        } else {
            byte = 0xFF;                     /* past end: all 1s */
        }
        b->cache |= byte << b->ncache;
        b->ncache += 8;
        b->bytepos++;
    }
}

static inline void wv_init(wv_bits *b, const unsigned char *buf,
                           uint64_t pos, uint64_t limit) {
    b->buf = buf;
    b->limit = limit;
    b->bytepos = pos >> 3;
    b->cache = 0;
    b->ncache = 0;
    wv_refill(b);
    int skip = (int)(pos & 7);
    b->cache >>= skip;
    b->ncache -= skip;
}

static inline int wv_getbit(wv_bits *b) {
    if (b->ncache == 0)
        wv_refill(b);
    int bit = (int)(b->cache & 1);
    b->cache >>= 1;
    b->ncache--;
    return bit;
}

static inline uint32_t wv_getbits(wv_bits *b, int n) {
    if (n == 0) return 0;
    if (b->ncache < n)
        wv_refill(b);
    uint32_t v = (uint32_t)(b->cache & ((n == 32) ? ~0u
                                        : ((1u << n) - 1)));
    b->cache >>= n;
    b->ncache -= n;
    return v;
}

/* Unary run of 1s terminated by a 0, capped at `cap` ones (the WavPack
 * ones_count==17 / cbits==33 escapes).  Counts whole runs with ctz on
 * the 64-bit cache instead of bit-at-a-time.  Consumes the terminating
 * zero iff the run ended below the cap — identical consumption to the
 * `while (getbit())` loops it replaces. */
static inline uint32_t wv_read_unary(wv_bits *b, uint32_t cap) {
    uint32_t count = 0;
    for (;;) {
        if (b->ncache == 0)
            wv_refill(b);
        uint64_t inv = ~b->cache;   /* bits >= ncache are 0 in cache */
        int run = inv ? (int)__builtin_ctzll(inv) : 64;
        if (run > b->ncache)
            run = b->ncache;
        if (count + (uint32_t)run >= cap) {
            uint32_t take = cap - count;
            b->cache >>= take;
            b->ncache -= (int)take;
            return cap;
        }
        if (run == b->ncache) {     /* cache is all ones: keep counting */
            count += (uint32_t)run;
            b->cache = 0;
            b->ncache = 0;
            continue;
        }
        int consume = run + 1;      /* the ones + the terminating zero */
        b->cache = (consume >= 64) ? 0 : (b->cache >> consume);
        b->ncache -= consume;
        return count + (uint32_t)run;
    }
}

static inline uint32_t wv_read_code(wv_bits *b, uint32_t maxcode) {
    if (maxcode < 2)
        return maxcode ? (uint32_t)wv_getbit(b) : 0;
    int bitcount = 32 - __builtin_clz(maxcode);
    uint32_t extras = (1u << bitcount) - maxcode - 1;
    /* Branchless: peek bitcount bits (LSB-first, so the first
     * bitcount-1 read bits are the low bits), decide with a cmov
     * whether the extra bit is consumed — the data-dependent
     * `code >= extras` branch mispredicts ~50% on real streams. */
    if (b->ncache < bitcount)
        wv_refill(b);
    uint32_t peek = (uint32_t)(b->cache
        & ((bitcount == 32) ? 0xFFFFFFFFu : ((1u << bitcount) - 1)));
    uint32_t small = peek & ((1u << (bitcount - 1)) - 1);
    uint32_t eb = (peek >> (bitcount - 1)) & 1;
    int cond = small >= extras;
    uint32_t value = cond ? ((small << 1) - extras + eb) : small;
    int consume = bitcount - 1 + cond;
    b->cache >>= consume;
    b->ncache -= consume;
    return value;
}

/* read_code immediately followed by its sign bit — the universal tail
 * of every WavPack word (read_words.c:280).  One refill + one cache
 * update instead of two primitive calls; returns (base+code) with the
 * sign applied, i.e. out = (base + code) ^ -sign. */
static inline int32_t wv_read_code_signed(wv_bits *b, uint32_t maxcode,
                                          uint32_t base) {
    uint32_t value, sign;
    int consume;
    if (maxcode < 2) {
        if (b->ncache < 2)
            wv_refill(b);
        if (maxcode) {
            value = (uint32_t)(b->cache & 1);
            sign = (uint32_t)((b->cache >> 1) & 1);
            consume = 2;
        } else {
            value = 0;
            sign = (uint32_t)(b->cache & 1);
            consume = 1;
        }
    } else {
        int bitcount = 32 - __builtin_clz(maxcode);
        uint32_t extras = (1u << bitcount) - maxcode - 1;
        if (b->ncache < bitcount + 1)
            wv_refill(b);
        uint32_t peek = (uint32_t)(b->cache
            & ((bitcount == 32) ? 0xFFFFFFFFu : ((1u << bitcount) - 1)));
        uint32_t small = peek & ((1u << (bitcount - 1)) - 1);
        uint32_t eb = (peek >> (bitcount - 1)) & 1;
        int cond = small >= extras;
        value = cond ? ((small << 1) - extras + eb) : small;
        consume = bitcount - 1 + cond;
        sign = (uint32_t)((b->cache >> consume) & 1);
        consume += 1;
    }
    b->cache >>= consume;
    b->ncache -= consume;
    return (int32_t)(base + value) ^ -(int32_t)sign;
}

#define WV_GET_MED(c, m) ((med[(c) * 3 + (m)] >> 4) + 1)
#define WV_INC_MED0(c) (med[(c)*3+0] += ((med[(c)*3+0] + 128) / 128) * 5)
#define WV_DEC_MED0(c) (med[(c)*3+0] -= ((med[(c)*3+0] + 126) / 128) * 2)
#define WV_INC_MED1(c) (med[(c)*3+1] += ((med[(c)*3+1] + 64) / 64) * 5)
#define WV_DEC_MED1(c) (med[(c)*3+1] -= ((med[(c)*3+1] + 62) / 64) * 2)
#define WV_INC_MED2(c) (med[(c)*3+2] += ((med[(c)*3+2] + 32) / 32) * 5)
#define WV_DEC_MED2(c) (med[(c)*3+2] -= ((med[(c)*3+2] + 30) / 32) * 2)

/* st: [holding_one, holding_zero, zeros_acc, values_written] */
uint64_t wv_words_lossless(const unsigned char *buf, uint64_t limit_bits,
                           uint64_t pos, int32_t *out, int64_t nvalues,
                           uint32_t *med_io, uint32_t *st, int mono)
{
    wv_bits bs; wv_init(&bs, buf, pos, limit_bits);
    uint32_t holding_one = st[0], holding_zero = st[1], zeros_acc = st[2];
    /* medians live in a local array so the compiler can prove the
     * out[n] stores never alias them (med_io and out are caller
     * pointers; the strict-aliasing case is too subtle to rely on) */
    uint32_t med[6];
    for (int i = 0; i < 6; i++) med[i] = med_io[i];
    int64_t n;

    for (n = 0; n < nvalues; n++) {
        int c = mono ? 0 : (int)(n & 1);
        uint32_t ones_count, low, high;

        if (holding_zero) {
            holding_zero = 0;
            uint32_t max0 = WV_GET_MED(c, 0) - 1;
            WV_DEC_MED0(c);
            out[n] = wv_read_code_signed(&bs, max0, 0);
            if (++n == nvalues)
                break;
            c = mono ? 0 : (int)(n & 1);
        }

        if (med[0] < 2 && !holding_one && med[3] < 2) {
            if (zeros_acc) {
                if (--zeros_acc) {
                    out[n] = 0;
                    continue;
                }
            }
            else {
                int cbits = (int)wv_read_unary(&bs, 33);
                if (cbits == 33)
                    break;
                if (cbits < 2)
                    zeros_acc = cbits;
                else
                    zeros_acc = wv_getbits(&bs, cbits - 1)
                                | (1u << (cbits - 1));
                if (zeros_acc) {
                    for (int i = 0; i < 6; i++)
                        med[i] = 0;
                    out[n] = 0;
                    continue;
                }
            }
        }

        ones_count = wv_read_unary(&bs, 17);
        if (ones_count == 17)
            break;
        if (ones_count == 16) {
            int cbits = (int)wv_read_unary(&bs, 33);
            if (cbits == 33)
                break;
            if (cbits < 2)
                ones_count = cbits;
            else
                ones_count = wv_getbits(&bs, cbits - 1)
                             | (1u << (cbits - 1));
            ones_count += 16;
        }

        low = holding_one;
        holding_one = ones_count & 1;
        holding_zero = ~ones_count & 1;
        ones_count = (ones_count >> 1) + low;

        /* Branchless form of the read_words.c median ladder: the
         * ones_count tree (0 / 1 / 2 / 3+) mispredicts heavily on real
         * residual streams, so compute all three rungs and select with
         * cmov.  Semantics identical to the nested-if original. */
        {
            uint32_t m0 = med[c * 3 + 0], m1 = med[c * 3 + 1],
                     m2 = med[c * 3 + 2];
            uint32_t g0 = (m0 >> 4) + 1, g1 = (m1 >> 4) + 1,
                     g2 = (m2 >> 4) + 1;
            int t1 = ones_count >= 1, t2 = ones_count >= 2,
                t3 = ones_count >= 3;
            low = (t1 ? g0 : 0) + (t2 ? g1 : 0)
                  + (t3 ? (ones_count - 2) * g2 : 0);
            high = low + (t2 ? g2 : (t1 ? g1 : g0)) - 1;
            med[c * 3 + 0] = t1 ? m0 + ((m0 + 128) >> 7) * 5
                                : m0 - ((m0 + 126) >> 7) * 2;
            if (t1)
                med[c * 3 + 1] = t2 ? m1 + ((m1 + 64) >> 6) * 5
                                    : m1 - ((m1 + 62) >> 6) * 2;
            if (t2)
                med[c * 3 + 2] = t3 ? m2 + ((m2 + 32) >> 5) * 5
                                    : m2 - ((m2 + 30) >> 5) * 2;
        }

        out[n] = wv_read_code_signed(&bs, high - low, low);
    }

    for (int i = 0; i < 6; i++) med_io[i] = med[i];
    st[0] = holding_one;
    st[1] = holding_zero;
    st[2] = zeros_acc;
    st[3] = (uint32_t)n;
    return wv_tell(&bs);
}

/* weight application/update (wavpack_local.h:532-571 semantics) */
static inline int32_t wv_apply_weight(int32_t weight, int32_t sample) {
    /* exact int32-wrapping semantics of the C macros */
    if (sample != (int16_t)sample) {
        int32_t lo = (int32_t)(((int64_t)(sample & 0xffff) * weight) >> 9);
        int32_t hi = (int32_t)((int64_t)((sample & ~0xffff) >> 9) * weight);
        return (int32_t)((int64_t)lo + hi + 1) >> 1;
    }
    return ((int32_t)((int64_t)weight * sample) + 512) >> 10;
}

#define WV_UPDATE_WEIGHT(w, d, s, r) \
    if ((s) && (r)) { int32_t _s = (int32_t)((s) ^ (r)) >> 31; \
        (w) = ((d) ^ _s) + ((w) - _s); }

#define WV_UPDATE_WEIGHT_CLIP(w, d, s, r) \
    if ((s) && (r)) { const int32_t _s = ((s) ^ (r)) >> 31; \
        if (((w) = ((w) ^ _s) + ((d) - _s)) > 1024) (w) = 1024; \
        (w) = ((w) ^ _s) - _s; }

void wv_decorr_mono(int term, int delta, int32_t *weight_io,
                    int32_t *samples_a, int32_t *buf, int64_t nsamples)
{
    int32_t weight = weight_io[0], sam;
    int m, k;
    int64_t i;

    if (term == 17) {
        for (i = 0; i < nsamples; i++) {
            sam = 2 * samples_a[0] - samples_a[1];
            samples_a[1] = samples_a[0];
            samples_a[0] = wv_apply_weight(weight, sam) + buf[i];
            WV_UPDATE_WEIGHT(weight, delta, sam, buf[i]);
            buf[i] = samples_a[0];
        }
    }
    else if (term == 18) {
        for (i = 0; i < nsamples; i++) {
            sam = (3 * samples_a[0] - samples_a[1]) >> 1;
            samples_a[1] = samples_a[0];
            samples_a[0] = wv_apply_weight(weight, sam) + buf[i];
            WV_UPDATE_WEIGHT(weight, delta, sam, buf[i]);
            buf[i] = samples_a[0];
        }
    }
    else {
        for (m = 0, k = term & 7, i = 0; i < nsamples; i++) {
            sam = samples_a[m];
            samples_a[k] = wv_apply_weight(weight, sam) + buf[i];
            WV_UPDATE_WEIGHT(weight, delta, sam, buf[i]);
            buf[i] = samples_a[k];
            m = (m + 1) & 7;
            k = (k + 1) & 7;
        }
        if (m) {
            int32_t tmp[8];
            for (k = 0; k < 8; k++)
                tmp[k] = samples_a[k];
            for (k = 0; k < 8; k++, m++)
                samples_a[k] = tmp[m & 7];
        }
    }
    weight_io[0] = weight;
}

void wv_decorr_stereo(int term, int delta, int32_t *weights,
                      int32_t *samples_a, int32_t *samples_b,
                      int32_t *buf, int64_t nsamples)
{
    int32_t weight_a = weights[0], weight_b = weights[1], sam, tmp;
    int64_t i, nv = nsamples * 2;
    int m, k;

    if (term == 17) {
        for (i = 0; i < nv; i += 2) {
            sam = 2 * samples_a[0] - samples_a[1];
            samples_a[1] = samples_a[0];
            buf[i] = samples_a[0] = wv_apply_weight(weight_a, sam) + (tmp = buf[i]);
            WV_UPDATE_WEIGHT(weight_a, delta, sam, tmp);
            sam = 2 * samples_b[0] - samples_b[1];
            samples_b[1] = samples_b[0];
            buf[i+1] = samples_b[0] = wv_apply_weight(weight_b, sam) + (tmp = buf[i+1]);
            WV_UPDATE_WEIGHT(weight_b, delta, sam, tmp);
        }
    }
    else if (term == 18) {
        for (i = 0; i < nv; i += 2) {
            sam = samples_a[0] + ((samples_a[0] - samples_a[1]) >> 1);
            samples_a[1] = samples_a[0];
            buf[i] = samples_a[0] = wv_apply_weight(weight_a, sam) + (tmp = buf[i]);
            WV_UPDATE_WEIGHT(weight_a, delta, sam, tmp);
            sam = samples_b[0] + ((samples_b[0] - samples_b[1]) >> 1);
            samples_b[1] = samples_b[0];
            buf[i+1] = samples_b[0] = wv_apply_weight(weight_b, sam) + (tmp = buf[i+1]);
            WV_UPDATE_WEIGHT(weight_b, delta, sam, tmp);
        }
    }
    else if (term > 0) {
        for (m = 0, k = term & 7, i = 0; i < nv; i += 2) {
            sam = samples_a[m];
            samples_a[k] = wv_apply_weight(weight_a, sam) + buf[i];
            WV_UPDATE_WEIGHT(weight_a, delta, sam, buf[i]);
            buf[i] = samples_a[k];
            sam = samples_b[m];
            samples_b[k] = wv_apply_weight(weight_b, sam) + buf[i+1];
            WV_UPDATE_WEIGHT(weight_b, delta, sam, buf[i+1]);
            buf[i+1] = samples_b[k];
            m = (m + 1) & 7;
            k = (k + 1) & 7;
        }
    }
    else if (term == -1) {
        for (i = 0; i < nv; i += 2) {
            sam = buf[i] + wv_apply_weight(weight_a, samples_a[0]);
            WV_UPDATE_WEIGHT_CLIP(weight_a, delta, samples_a[0], buf[i]);
            buf[i] = sam;
            samples_a[0] = buf[i+1] + wv_apply_weight(weight_b, sam);
            WV_UPDATE_WEIGHT_CLIP(weight_b, delta, sam, buf[i+1]);
            buf[i+1] = samples_a[0];
        }
    }
    else if (term == -2) {
        for (i = 0; i < nv; i += 2) {
            sam = buf[i+1] + wv_apply_weight(weight_b, samples_b[0]);
            WV_UPDATE_WEIGHT_CLIP(weight_b, delta, samples_b[0], buf[i+1]);
            buf[i+1] = sam;
            samples_b[0] = buf[i] + wv_apply_weight(weight_a, sam);
            WV_UPDATE_WEIGHT_CLIP(weight_a, delta, sam, buf[i]);
            buf[i] = samples_b[0];
        }
    }
    else if (term == -3) {
        for (i = 0; i < nv; i += 2) {
            int32_t sam_a = buf[i] + wv_apply_weight(weight_a, samples_a[0]);
            WV_UPDATE_WEIGHT_CLIP(weight_a, delta, samples_a[0], buf[i]);
            int32_t sam_b = buf[i+1] + wv_apply_weight(weight_b, samples_b[0]);
            WV_UPDATE_WEIGHT_CLIP(weight_b, delta, samples_b[0], buf[i+1]);
            buf[i] = samples_b[0] = sam_a;
            buf[i+1] = samples_a[0] = sam_b;
        }
    }
    weights[0] = weight_a;
    weights[1] = weight_b;
}

/* Lossless float restore using the wvx side-bitstream                */
/* (reference: wavpack/src/unpack_floats.c float_values).             */
void wv_float_values(int32_t *values, int64_t n, const unsigned char *wvx,
                     uint64_t wvx_bits, int float_flags, int float_shift,
                     int float_max_exp, uint32_t *out_bits)
{
    wv_bits bs; wv_init(&bs, wvx, 0, wvx_bits);

    for (int64_t i = 0; i < n; i++) {
        int shift_count = 0, exp = float_max_exp;
        uint32_t sign = 0, mantissa = 0, exponent = 0;
        int32_t v = values[i];

        if (v == 0) {
            if (float_flags & 8) {              /* FLOAT_ZEROS_SENT */
                if (wv_getbit(&bs)) {
                    mantissa = wv_getbits(&bs, 23);
                    if (exp >= 25)
                        exponent = wv_getbits(&bs, 8);
                    sign = wv_getbit(&bs);
                }
                else if (float_flags & 0x10)    /* FLOAT_NEG_ZEROS */
                    sign = wv_getbit(&bs);
            }
        }
        else {
            v = (int32_t)((uint32_t)v << float_shift);
            if (v < 0) {
                v = -v;
                sign = 1;
            }
            if (v == 0x1000000) {
                if (wv_getbit(&bs))
                    mantissa = wv_getbits(&bs, 23);
                exponent = 255;
            }
            else {
                if (exp)
                    while (!(v & 0x800000) && --exp) {
                        shift_count++;
                        v <<= 1;
                    }
                if (shift_count) {
                    if ((float_flags & 1) ||            /* SHIFT_ONES */
                        ((float_flags & 2) && wv_getbit(&bs)))  /* SAME */
                        v |= (1 << shift_count) - 1;
                    else if (float_flags & 4)           /* SHIFT_SENT */
                        v |= wv_getbits(&bs, shift_count)
                             & ((1u << shift_count) - 1);
                }
                mantissa = (uint32_t)v & 0x7fffff;
                exponent = (uint32_t)exp;
            }
        }
        out_bits[i] = (sign << 31) | (exponent << 23) | mantissa;
    }
}

/* Lossy float restore without the wvx side-bitstream                 */
/* (reference: wavpack/src/unpack_floats.c float_values_nowvx).       */
void wv_float_nowvx(const int32_t *values, int64_t n, int float_flags,
                    int float_shift, int float_max_exp, uint32_t *out_bits)
{
    for (int64_t i = 0; i < n; i++) {
        int shift_count = 0, exp = float_max_exp;
        uint32_t sign = 0;
        int32_t v = values[i];

        if (v == 0) {
            out_bits[i] = 0;
            continue;
        }
        v = (int32_t)((uint32_t)v << float_shift);
        if (v < 0) {
            v = -v;
            sign = 1;
        }
        if (v >= 0x1000000) {
            while (v & 0xf000000) {
                v >>= 1;
                exp++;
            }
        }
        else if (exp) {
            while (!(v & 0x800000) && --exp) {
                shift_count++;
                v <<= 1;
            }
            if (shift_count && (float_flags & 1))       /* SHIFT_ONES */
                v |= (1 << shift_count) - 1;
        }
        out_bits[i] = (sign << 31) | (((uint32_t)exp & 0xff) << 23)
                      | ((uint32_t)v & 0x7fffff);
    }
}

/* ------------------------------------------------------------------ */
/* WavPack hybrid (lossy) entropy words (read_words.c:67 get_word,    */
/* entropy_utils.c:update_error_limit / wp_log2 / wp_exp2s).          */
/* ------------------------------------------------------------------ */

static const unsigned char wv_nbits_table[256] = {
    0,1,2,2,3,3,3,3,4,4,4,4,4,4,4,4,5,5,5,5,5,5,5,5,5,5,5,5,5,5,5,5,
    6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,
    7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,
    7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,
    8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,
    8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,
    8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,
    8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8,8
};

static const unsigned char wv_log2_table[256] = {
    0x00,0x01,0x03,0x04,0x06,0x07,0x09,0x0a,0x0b,0x0d,0x0e,0x10,0x11,0x12,0x14,0x15,
    0x16,0x18,0x19,0x1a,0x1c,0x1d,0x1e,0x20,0x21,0x22,0x24,0x25,0x26,0x28,0x29,0x2a,
    0x2c,0x2d,0x2e,0x2f,0x31,0x32,0x33,0x34,0x36,0x37,0x38,0x39,0x3b,0x3c,0x3d,0x3e,
    0x3f,0x41,0x42,0x43,0x44,0x45,0x47,0x48,0x49,0x4a,0x4b,0x4d,0x4e,0x4f,0x50,0x51,
    0x52,0x54,0x55,0x56,0x57,0x58,0x59,0x5a,0x5c,0x5d,0x5e,0x5f,0x60,0x61,0x62,0x63,
    0x64,0x66,0x67,0x68,0x69,0x6a,0x6b,0x6c,0x6d,0x6e,0x6f,0x70,0x71,0x72,0x74,0x75,
    0x76,0x77,0x78,0x79,0x7a,0x7b,0x7c,0x7d,0x7e,0x7f,0x80,0x81,0x82,0x83,0x84,0x85,
    0x86,0x87,0x88,0x89,0x8a,0x8b,0x8c,0x8d,0x8e,0x8f,0x90,0x91,0x92,0x93,0x94,0x95,
    0x96,0x97,0x98,0x99,0x9a,0x9b,0x9b,0x9c,0x9d,0x9e,0x9f,0xa0,0xa1,0xa2,0xa3,0xa4,
    0xa5,0xa6,0xa7,0xa8,0xa9,0xa9,0xaa,0xab,0xac,0xad,0xae,0xaf,0xb0,0xb1,0xb2,0xb2,
    0xb3,0xb4,0xb5,0xb6,0xb7,0xb8,0xb9,0xb9,0xba,0xbb,0xbc,0xbd,0xbe,0xbf,0xc0,0xc0,
    0xc1,0xc2,0xc3,0xc4,0xc5,0xc6,0xc6,0xc7,0xc8,0xc9,0xca,0xcb,0xcb,0xcc,0xcd,0xce,
    0xcf,0xd0,0xd0,0xd1,0xd2,0xd3,0xd4,0xd4,0xd5,0xd6,0xd7,0xd8,0xd8,0xd9,0xda,0xdb,
    0xdc,0xdc,0xdd,0xde,0xdf,0xe0,0xe0,0xe1,0xe2,0xe3,0xe4,0xe4,0xe5,0xe6,0xe7,0xe7,
    0xe8,0xe9,0xea,0xea,0xeb,0xec,0xed,0xee,0xee,0xef,0xf0,0xf1,0xf1,0xf2,0xf3,0xf4,
    0xf4,0xf5,0xf6,0xf7,0xf7,0xf8,0xf9,0xf9,0xfa,0xfb,0xfc,0xfc,0xfd,0xfe,0xff,0xff
};

static const unsigned char wv_exp2_table[256] = {
    0x00,0x01,0x01,0x02,0x03,0x03,0x04,0x05,0x06,0x06,0x07,0x08,0x08,0x09,0x0a,0x0b,
    0x0b,0x0c,0x0d,0x0e,0x0e,0x0f,0x10,0x10,0x11,0x12,0x13,0x13,0x14,0x15,0x16,0x16,
    0x17,0x18,0x19,0x19,0x1a,0x1b,0x1c,0x1d,0x1d,0x1e,0x1f,0x20,0x20,0x21,0x22,0x23,
    0x24,0x24,0x25,0x26,0x27,0x28,0x28,0x29,0x2a,0x2b,0x2c,0x2c,0x2d,0x2e,0x2f,0x30,
    0x30,0x31,0x32,0x33,0x34,0x35,0x35,0x36,0x37,0x38,0x39,0x3a,0x3a,0x3b,0x3c,0x3d,
    0x3e,0x3f,0x40,0x41,0x41,0x42,0x43,0x44,0x45,0x46,0x47,0x48,0x48,0x49,0x4a,0x4b,
    0x4c,0x4d,0x4e,0x4f,0x50,0x51,0x51,0x52,0x53,0x54,0x55,0x56,0x57,0x58,0x59,0x5a,
    0x5b,0x5c,0x5d,0x5e,0x5e,0x5f,0x60,0x61,0x62,0x63,0x64,0x65,0x66,0x67,0x68,0x69,
    0x6a,0x6b,0x6c,0x6d,0x6e,0x6f,0x70,0x71,0x72,0x73,0x74,0x75,0x76,0x77,0x78,0x79,
    0x7a,0x7b,0x7c,0x7d,0x7e,0x7f,0x80,0x81,0x82,0x83,0x84,0x85,0x87,0x88,0x89,0x8a,
    0x8b,0x8c,0x8d,0x8e,0x8f,0x90,0x91,0x92,0x93,0x95,0x96,0x97,0x98,0x99,0x9a,0x9b,
    0x9c,0x9d,0x9f,0xa0,0xa1,0xa2,0xa3,0xa4,0xa5,0xa6,0xa8,0xa9,0xaa,0xab,0xac,0xad,
    0xaf,0xb0,0xb1,0xb2,0xb3,0xb4,0xb6,0xb7,0xb8,0xb9,0xba,0xbc,0xbd,0xbe,0xbf,0xc0,
    0xc2,0xc3,0xc4,0xc5,0xc6,0xc8,0xc9,0xca,0xcb,0xcd,0xce,0xcf,0xd0,0xd2,0xd3,0xd4,
    0xd6,0xd7,0xd8,0xd9,0xdb,0xdc,0xdd,0xde,0xe0,0xe1,0xe2,0xe4,0xe5,0xe6,0xe8,0xe9,
    0xea,0xec,0xed,0xee,0xf0,0xf1,0xf2,0xf4,0xf5,0xf6,0xf8,0xf9,0xfa,0xfc,0xfd,0xff
};

static int32_t wv_exp2s(int logval) {
    uint32_t value;
    if (logval < 0)
        return -wv_exp2s(-logval);
    value = wv_exp2_table[logval & 0xff] | 0x100;
    logval >>= 8;
    return (logval <= 9) ? (int32_t)(value >> (9 - logval))
                         : (int32_t)(value << (logval - 9));
}

static int wv_log2(uint32_t avalue) {
    int dbits;
    if ((avalue += avalue >> 9) < (1 << 8)) {
        dbits = wv_nbits_table[avalue];
        return (dbits << 8) + wv_log2_table[(avalue << (9 - dbits)) & 0xff];
    }
    if (avalue < (1u << 16))
        dbits = wv_nbits_table[avalue >> 8] + 8;
    else if (avalue < (1u << 24))
        dbits = wv_nbits_table[avalue >> 16] + 16;
    else
        dbits = wv_nbits_table[avalue >> 24] + 24;
    return (dbits << 8) + wv_log2_table[(avalue >> (dbits - 9)) & 0xff];
}

#define WV_SLS 8
#define WV_SLO (1 << (WV_SLS - 1))

/* hs: [slow0, slow1, acc0, acc1, delta0, delta1] (int32), updated.
   flg: bit0 hybrid_bitrate, bit1 hybrid_balance, bit2 mono.
   st: [holding_one, holding_zero, zeros_acc, values_written]. */
uint64_t wv_words_hybrid(const unsigned char *buf, uint64_t limit_bits,
                         uint64_t pos, int32_t *out, int64_t nvalues,
                         uint32_t *med, uint32_t *st, int32_t *hs, int flg)
{
    wv_bits bs; wv_init(&bs, buf, pos, limit_bits);
    uint32_t holding_one = st[0], holding_zero = st[1], zeros_acc = st[2];
    uint32_t error_limit[2] = {0, 0};
    int mono = (flg >> 2) & 1, hbr = flg & 1, hbal = (flg >> 1) & 1;
    int64_t n;

    for (n = 0; n < nvalues; n++) {
        int c = mono ? 0 : (int)(n & 1);
        uint32_t ones_count, low, mid, high;
        int sign;

        if (!(med[0] & ~1u) && !holding_zero && !holding_one
            && !(med[3] & ~1u)) {
            if (zeros_acc) {
                if (--zeros_acc) {
                    hs[c] -= (hs[c] + WV_SLO) >> WV_SLS;
                    out[n] = 0;
                    continue;
                }
            }
            else {
                int cbits = (int)wv_read_unary(&bs, 33);
                if (cbits == 33)
                    break;
                if (cbits < 2)
                    zeros_acc = cbits;
                else
                    zeros_acc = wv_getbits(&bs, cbits - 1)
                                | (1u << (cbits - 1));
                if (zeros_acc) {
                    hs[c] -= (hs[c] + WV_SLO) >> WV_SLS;
                    for (int i = 0; i < 6; i++)
                        med[i] = 0;
                    out[n] = 0;
                    continue;
                }
            }
        }

        if (holding_zero)
            ones_count = holding_zero = 0;
        else {
            ones_count = wv_read_unary(&bs, 17);
            if (ones_count == 17)
                break;
            if (ones_count == 16) {
                int cbits = (int)wv_read_unary(&bs, 33);
                if (cbits == 33)
                    break;
                if (cbits < 2)
                    ones_count = cbits;
                else
                    ones_count = wv_getbits(&bs, cbits - 1)
                                 | (1u << (cbits - 1));
                ones_count += 16;
            }
            if (holding_one) {
                holding_one = ones_count & 1;
                ones_count = (ones_count >> 1) + 1;
            }
            else {
                holding_one = ones_count & 1;
                ones_count >>= 1;
            }
            holding_zero = ~holding_one & 1;
        }

        if (c == 0) {
            /* update_error_limit (entropy_utils.c); bitrate_acc is
               uint32 -> logical shift */
            int b0;
            hs[2] = (int32_t)((uint32_t)hs[2] + (uint32_t)hs[4]);
            b0 = (int)((uint32_t)hs[2] >> 16);
            if (mono) {
                if (hbr) {
                    int sl0 = (hs[0] + WV_SLO) >> WV_SLS;
                    error_limit[0] = (sl0 - b0 > -0x100)
                        ? (uint32_t)wv_exp2s(sl0 - b0 + 0x100) : 0;
                }
                else
                    error_limit[0] = (uint32_t)wv_exp2s(b0);
            }
            else {
                int b1;
                hs[3] = (int32_t)((uint32_t)hs[3] + (uint32_t)hs[5]);
                b1 = (int)((uint32_t)hs[3] >> 16);
                if (hbr) {
                    int sl0 = (hs[0] + WV_SLO) >> WV_SLS;
                    int sl1 = (hs[1] + WV_SLO) >> WV_SLS;
                    if (hbal) {
                        int balance = (sl1 - sl0 + b1 + 1) >> 1;
                        if (balance > b0) {
                            b1 = b0 * 2;
                            b0 = 0;
                        }
                        else if (-balance > b0) {
                            b0 = b0 * 2;
                            b1 = 0;
                        }
                        else {
                            b1 = b0 + balance;
                            b0 = b0 - balance;
                        }
                    }
                    error_limit[0] = (sl0 - b0 > -0x100)
                        ? (uint32_t)wv_exp2s(sl0 - b0 + 0x100) : 0;
                    error_limit[1] = (sl1 - b1 > -0x100)
                        ? (uint32_t)wv_exp2s(sl1 - b1 + 0x100) : 0;
                }
                else {
                    error_limit[0] = (uint32_t)wv_exp2s(b0);
                    error_limit[1] = (uint32_t)wv_exp2s(b1);
                }
            }
        }

        if (ones_count == 0) {
            low = 0;
            high = WV_GET_MED(c, 0) - 1;
            WV_DEC_MED0(c);
        }
        else {
            low = WV_GET_MED(c, 0);
            WV_INC_MED0(c);
            if (ones_count == 1) {
                high = low + WV_GET_MED(c, 1) - 1;
                WV_DEC_MED1(c);
            }
            else {
                low += WV_GET_MED(c, 1);
                WV_INC_MED1(c);
                if (ones_count == 2) {
                    high = low + WV_GET_MED(c, 2) - 1;
                    WV_DEC_MED2(c);
                }
                else {
                    low += (ones_count - 2) * WV_GET_MED(c, 2);
                    high = low + WV_GET_MED(c, 2) - 1;
                    WV_INC_MED2(c);
                }
            }
        }

        low &= 0x7fffffff;
        high &= 0x7fffffff;
        if (low > high)
            high = low;
        mid = (high + low + 1) >> 1;

        if (!error_limit[c])
            mid = wv_read_code(&bs, high - low) + low;
        else while (high - low > error_limit[c]) {
            if (wv_getbit(&bs))
                mid = (high + (low = mid) + 1) >> 1;
            else
                mid = ((high = mid - 1) + low + 1) >> 1;
        }

        sign = wv_getbit(&bs);
        if (hbr) {
            hs[c] -= (hs[c] + WV_SLO) >> WV_SLS;
            hs[c] += wv_log2(mid);
        }
        out[n] = sign ? ~(int32_t)mid : (int32_t)mid;
    }

    st[0] = holding_one;
    st[1] = holding_zero;
    st[2] = zeros_acc;
    st[3] = (uint32_t)n;
    return wv_tell(&bs);
}

/* Fused whole-block decode: entropy words -> decorrelation passes ->
 * joint-stereo undo in one native call (one ctypes crossing per block
 * instead of one per stage; the words output stays hot in cache for the
 * first decorr pass).  Reference semantics: wavpack/src/unpack.c
 * unpack_samples.  weights is [npasses][2] in/out; samples_a/samples_b
 * are [npasses][8] in/out (the per-term history windows).  Returns the
 * final bit position; the caller checks st[3]==nvalues for underrun. */
uint64_t wv_decode_block(const unsigned char *buf, uint64_t limit_bits,
                         int32_t *out, int64_t nvalues,
                         uint32_t *med, uint32_t *st,
                         int32_t *hyb, int hflg, int hybrid,
                         int npasses, const int32_t *terms,
                         const int32_t *deltas, int32_t *weights,
                         int32_t *samples_a, int32_t *samples_b,
                         int mono, int joint, int64_t block_samples)
{
    uint64_t pos;
    if (hybrid)
        pos = wv_words_hybrid(buf, limit_bits, 0, out, nvalues,
                              med, st, hyb, hflg);
    else
        pos = wv_words_lossless(buf, limit_bits, 0, out, nvalues,
                                med, st, mono);
    if (st[3] != (uint32_t)nvalues)
        return pos;
    for (int p = 0; p < npasses; p++) {
        if (mono)
            wv_decorr_mono(terms[p], deltas[p], weights + p * 2,
                           samples_a + p * 8, out, block_samples);
        else
            wv_decorr_stereo(terms[p], deltas[p], weights + p * 2,
                             samples_a + p * 8, samples_b + p * 8,
                             out, block_samples);
    }
    if (!mono && joint) {
        /* unpack.c:199 joint stereo undo, int32 wrap semantics */
        for (int64_t i = 0; i < nvalues; i += 2) {
            out[i + 1] -= out[i] >> 1;
            out[i] += out[i + 1];
        }
    }
    return pos;
}
