/* Shared range decoder (RFC 6716 section 4.1), used by the CELT band
 * decoder (celt_bands.c) and the SILK decoder (silk_dec.c).
 *
 * C version of OUR Python implementation in formats/opus/range_coder.py
 * (itself validated bit-exactly against reference goldens; reference:
 * third_party/opus/celt/entdec.c, entcode.c).  State crosses the
 * Python<->C boundary as 10 int64s (ec_load/ec_store), matching
 * formats/opus/celt.py _ec_pack/_ec_unpack.
 */
#ifndef NQ_ECDEC_H
#define NQ_ECDEC_H

#include <stdint.h>

#define EC_SYM_BITS 8
#define EC_CODE_BITS 32
#define EC_SYM_MAX 255u
#define EC_CODE_TOP (1u << 31)
#define EC_CODE_BOT (EC_CODE_TOP >> EC_SYM_BITS)
#define EC_CODE_EXTRA 7
#define EC_UINT_BITS 8
#define EC_WINDOW_SIZE 32
#define BITRES 3

typedef struct {
    const uint8_t *buf;
    uint32_t storage;
    uint32_t offs, end_offs;
    uint64_t end_window;
    int nend_bits;
    int nbits_total;
    uint32_t rng, val, ext;
    int rem;
    int error;
} ecdec;

static inline int ec_ilog(uint32_t v) {
    int r = 0;
    while (v) { r++; v >>= 1; }
    return r;
}

static inline int ec_read_byte(ecdec *d) {
    return d->offs < d->storage ? d->buf[d->offs++] : 0;
}

static inline int ec_read_byte_from_end(ecdec *d) {
    return d->end_offs < d->storage
        ? d->buf[d->storage - ++(d->end_offs)] : 0;
}

static inline void ec_normalize(ecdec *d) {
    while (d->rng <= EC_CODE_BOT) {
        int sym;
        d->nbits_total += EC_SYM_BITS;
        d->rng <<= EC_SYM_BITS;
        sym = d->rem;
        d->rem = ec_read_byte(d);
        sym = ((sym << EC_SYM_BITS) | d->rem) >> (EC_SYM_BITS - EC_CODE_EXTRA);
        d->val = ((d->val << EC_SYM_BITS) + (EC_SYM_MAX & ~(uint32_t)sym))
                 & (EC_CODE_TOP - 1);
    }
}

static inline uint32_t ec_decode(ecdec *d, uint32_t ft) {
    uint32_t s;
    d->ext = d->rng / ft;
    s = d->val / d->ext;
    return ft - ((s + 1 < ft ? s + 1 : ft));
}

static inline void ec_update(ecdec *d, uint32_t fl, uint32_t fh,
                             uint32_t ft) {
    uint32_t s = d->ext * (ft - fh);
    d->val -= s;
    d->rng = fl > 0 ? d->ext * (fh - fl) : d->rng - s;
    ec_normalize(d);
}

static inline int ec_dec_bit_logp(ecdec *d, unsigned logp) {
    uint32_t r = d->rng, dv = d->val, s = r >> logp;
    int ret = dv < s;
    if (!ret) d->val = dv - s;
    d->rng = ret ? s : r - s;
    ec_normalize(d);
    return ret;
}

static inline uint32_t ec_dec_bits(ecdec *d, unsigned bits) {
    uint64_t window = d->end_window;
    int available = d->nend_bits;
    uint32_t ret;
    if ((unsigned)available < bits) {
        do {
            window |= (uint64_t)ec_read_byte_from_end(d) << available;
            available += EC_SYM_BITS;
        } while (available <= EC_WINDOW_SIZE - EC_SYM_BITS);
    }
    ret = (uint32_t)(window & (((uint64_t)1 << bits) - 1));
    window >>= bits;
    available -= bits;
    d->end_window = window;
    d->nend_bits = available;
    d->nbits_total += bits;
    return ret;
}

static inline uint32_t ec_dec_uint(ecdec *d, uint32_t ft) {
    int ftb;
    ft--;
    ftb = ec_ilog(ft);
    if (ftb > EC_UINT_BITS) {
        uint32_t ft_hi, s, t;
        ftb -= EC_UINT_BITS;
        ft_hi = (ft >> ftb) + 1;
        s = ec_decode(d, ft_hi);
        ec_update(d, s, s + 1, ft_hi);
        t = (s << ftb) | ec_dec_bits(d, ftb);
        if (t <= ft) return t;
        d->error = 1;
        return ft;
    }
    ft++;
    {
        uint32_t s = ec_decode(d, ft);
        ec_update(d, s, s + 1, ft);
        return s;
    }
}

static inline int64_t ec_tell_frac(const ecdec *d) {
    int64_t nbits = (int64_t)d->nbits_total << BITRES;
    int l = ec_ilog(d->rng);
    uint32_t r = d->rng >> (l - 16);
    int i;
    for (i = 0; i < BITRES; i++) {
        int b;
        r = (r * r) >> 15;
        b = r >> 16;
        l = (l << 1) | b;
        r >>= b;
    }
    return nbits - l;
}

static inline int64_t ec_tell(const ecdec *d) {
    return d->nbits_total - ec_ilog(d->rng);
}

static inline uint32_t ec_decode_bin(ecdec *d, unsigned bits) {
    uint32_t s;
    d->ext = d->rng >> bits;
    s = d->val / d->ext;
    return ((uint32_t)1 << bits)
        - (s + 1 < ((uint32_t)1 << bits) ? s + 1 : ((uint32_t)1 << bits));
}

static inline int ec_dec_icdf(ecdec *d, const uint8_t *icdf, unsigned ftb) {
    uint32_t r, s, t;
    int ret = -1;
    s = d->rng;
    r = s >> ftb;
    do {
        ret++;
        t = s;
        s = r * icdf[ret];
    } while (d->val < s);
    d->val -= s;
    d->rng = t - s;
    ec_normalize(d);
    return ret;
}

static inline void ec_init(ecdec *d, const uint8_t *buf, uint32_t storage) {
    d->buf = buf;
    d->storage = storage;
    d->offs = 0;
    d->end_offs = 0;
    d->end_window = 0;
    d->nend_bits = 0;
    d->nbits_total = 32 + 1 - ((32 - 7) / 8) * 8;   /* 9 */
    d->rng = 1u << 7;
    d->rem = ec_read_byte(d);
    d->val = d->rng - 1 - (uint32_t)(d->rem >> (8 - 7));
    d->ext = 0;
    d->error = 0;
    ec_normalize(d);
}

/* State layout (int64 x10): offs, end_offs, end_window, nend_bits,
   nbits_total, rng, rem, val, ext, error */
static inline void ec_load(ecdec *d, const uint8_t *buf, uint32_t storage,
                           const int64_t *st) {
    d->buf = buf;
    d->storage = storage;
    d->offs = (uint32_t)st[0];
    d->end_offs = (uint32_t)st[1];
    d->end_window = (uint64_t)st[2];
    d->nend_bits = (int)st[3];
    d->nbits_total = (int)st[4];
    d->rng = (uint32_t)st[5];
    d->rem = (int)st[6];
    d->val = (uint32_t)st[7];
    d->ext = (uint32_t)st[8];
    d->error = (int)st[9];
}

static inline void ec_store(const ecdec *d, int64_t *st) {
    st[0] = d->offs;
    st[1] = d->end_offs;
    st[2] = (int64_t)d->end_window;
    st[3] = d->nend_bits;
    st[4] = d->nbits_total;
    st[5] = d->rng;
    st[6] = d->rem;
    st[7] = d->val;
    st[8] = d->ext;
    st[9] = d->error;
}

#endif /* NQ_ECDEC_H */
