/* Whole-stream FLAC frame decoder (the host half of formats/flac.py).
 *
 * Decodes ALL audio frames of a FLAC stream in one call: frame sync +
 * header parse, subframe decode (constant / verbatim / fixed / LPC),
 * Rice-partitioned residuals, stereo decorrelation, and interleaving
 * into an int32 output buffer.  The int32 samples go to the card in one
 * copy and scale there (ops/lossless.py scale_int).
 *
 * Reference semantics (re-derived from the FLAC format spec; behavior
 * cross-checked against the reference's libFLAC):
 *   frame/subframe layout   third_party/FLAC/src/stream_decoder.c:2463-2533
 *   Rice residual           stream_decoder.c:2597 read_residual_partitioned_rice_
 *   integer LPC synthesis   third_party/FLAC/src/lpc.c:784 (wide :1045)
 *   fixed predictors        third_party/FLAC/src/fixed.c
 *
 * Neither CRC is verified (libFLAC verifies both).
 *
 * API: resumable at frame granularity so the caller never needs to know
 * the total sample count up front (constant subframes expand ~3 bytes
 * to up to 65535 samples, so output size is not boundable from input
 * size — the caller grows its buffer and resumes).
 */
#include <stdint.h>
#include <string.h>

/* 64-bit cached MSB-first bit reader.  The cache keeps the next
 * `ncache` bits MSB-aligned; refills pull whole bytes.  Rice residuals
 * are the bulk of a FLAC stream's bits, so reads must not touch memory
 * per bit (a byte-stepping reader measured ~2.5x slower on real
 * streams). */
typedef struct {
    const uint8_t *buf;
    int64_t nbytes;
    int64_t bytepos;   /* next byte to load into the cache */
    uint64_t cache;    /* MSB-aligned pending bits */
    int ncache;        /* number of valid top bits in cache */
    int overrun;       /* a read ran past the end (corrupt stream) */
} fbits;

static inline void fb_refill(fbits *br) {
    while (br->ncache <= 56 && br->bytepos < br->nbytes) {
        br->cache |= (uint64_t)br->buf[br->bytepos++] << (56 - br->ncache);
        br->ncache += 8;
    }
}

static inline void fb_init(fbits *br, const uint8_t *buf, int64_t nbytes,
                           int64_t bitpos) {
    br->buf = buf;
    br->nbytes = nbytes;
    br->bytepos = bitpos >> 3;
    br->cache = 0;
    br->ncache = 0;
    br->overrun = 0;
    int skip = (int)(bitpos & 7);
    fb_refill(br);
    if (skip) {                 /* mid-byte start */
        if (br->ncache < skip) { br->overrun = 1; return; }
        br->cache <<= skip;
        br->ncache -= skip;
    }
}

/* current absolute bit position (undefined after overrun) */
static inline int64_t fb_tell(const fbits *br) {
    return br->bytepos * 8 - br->ncache;
}

static inline uint32_t fb_read(fbits *br, int n) {
    if (n == 0) return 0;
    if (br->ncache < n) {
        fb_refill(br);
        if (br->ncache < n) {   /* corrupt: saturate with zeros */
            br->overrun = 1;
            uint32_t v = (uint32_t)(br->cache >> (64 - n));
            br->cache = 0;
            br->ncache = 0;
            return v;
        }
    }
    uint32_t v = (uint32_t)(br->cache >> (64 - n));
    br->cache <<= n;
    br->ncache -= n;
    return v;
}

static inline int32_t fb_read_signed(fbits *br, int n) {
    uint32_t v = fb_read(br, n);
    if (n == 0) return 0;
    return (int32_t)(v << (32 - n)) >> (32 - n);
}

static inline uint32_t fb_unary(fbits *br) {
    uint32_t q = 0;
    for (;;) {
        if (br->ncache == 0) {
            fb_refill(br);
            if (br->ncache == 0) { br->overrun = 1; return q; }
        }
        if (br->cache) {
            int lead = __builtin_clzll(br->cache);
            if (lead < br->ncache) {
                br->cache <<= lead + 1;
                br->ncache -= lead + 1;
                return q + lead;
            }
        }
        q += br->ncache;        /* cache is all zeros: consume it */
        br->cache = 0;
        br->ncache = 0;
    }
}

static inline void fb_align(fbits *br) {
    int r = (int)(fb_tell(br) & 7);
    if (r) fb_read(br, 8 - r);
}

/* frame-header UTF-8-coded number (frame or sample index; value unused,
   we only consume the bits).  Returns 0 ok, -1 malformed. */
static int fb_utf8_skip(fbits *br) {
    uint32_t v = fb_read(br, 8);
    if (v < 0x80) return 0;
    int n = 0;
    uint32_t mask = 0x40;
    while (v & mask) { n++; mask >>= 1; }
    if (n < 1 || n > 6) return -1;
    for (int i = 0; i < n; i++) {
        uint32_t c = fb_read(br, 8);
        if ((c & 0xC0) != 0x80) return -1;
    }
    return 0;
}

static const int32_t BLOCKSIZE_TAB[16] = {
    0, 192, 576, 1152, 2304, 4608, -1, -2, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768,
};
static const int32_t BPS_TAB[8] = { 0, 8, 12, 0, 16, 20, 24, 32 };

#define FLAC_MAX_BLOCK 65536
#define FLAC_MAX_ORDER 32
#define FLAC_MAX_CH 8

/* Rice-partitioned residual (spec §9.2.7; stream_decoder.c:2597). */
static int decode_residual(fbits *br, int32_t blocksize, int order,
                           int32_t *out) {
    uint32_t method = fb_read(br, 2);
    if (method > 1) return -1;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 15 : 31;
    uint32_t porder = fb_read(br, 4);
    int32_t nparts = 1 << porder;
    if (blocksize % nparts) return -1;
    int32_t part = blocksize >> porder;
    int64_t idx = 0;
    for (int32_t p = 0; p < nparts; p++) {
        int64_t n = part - (p == 0 ? order : 0);
        if (n < 0) return -1;
        uint32_t k = fb_read(br, plen);
        if (k == escape) {
            int eb = (int)fb_read(br, 5);
            for (int64_t i = 0; i < n; i++)
                out[idx + i] = eb ? fb_read_signed(br, eb) : 0;
        } else {
            for (int64_t i = 0; i < n; i++) {
                uint32_t q = fb_unary(br);
                uint32_t bits = k ? fb_read(br, (int)k) : 0;
                uint32_t u = (q << k) | bits;
                out[idx + i] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
            }
        }
        idx += n;
        if (br->overrun) return -1;
    }
    return 0;
}

/* One subframe into out[blocksize] (spec §9.2).
   scratch: FLAC_MAX_ORDER + FLAC_MAX_BLOCK int32s. */
static int decode_subframe(fbits *br, int32_t blocksize, int bps,
                           int32_t *out, int32_t *scratch) {
    if (fb_read(br, 1)) return -1;            /* padding bit */
    uint32_t sftype = fb_read(br, 6);
    int wasted = 0;
    if (fb_read(br, 1)) {
        wasted = 1 + (int)fb_unary(br);
        bps -= wasted;
        if (bps <= 0) return -1;              /* corrupt wasted count */
    }
    if (br->overrun) return -1;
    if (sftype == 0) {                         /* constant */
        int32_t v = fb_read_signed(br, bps);
        for (int32_t i = 0; i < blocksize; i++) out[i] = v;
    } else if (sftype == 1) {                  /* verbatim */
        for (int32_t i = 0; i < blocksize; i++)
            out[i] = fb_read_signed(br, bps);
    } else if (sftype >= 8 && sftype <= 12) {  /* fixed */
        int order = (int)sftype - 8;
        for (int i = 0; i < order; i++)
            out[i] = fb_read_signed(br, bps);
        int32_t *res = scratch;
        if (decode_residual(br, blocksize, order, res)) return -1;
        int64_t n = blocksize - order;
        int32_t *d = out + order;
        switch (order) {
        case 0:
            memcpy(d, res, (size_t)n * 4);
            break;
        case 1:
            for (int64_t i = 0; i < n; i++)
                d[i] = res[i] + d[i - 1];
            break;
        case 2:
            for (int64_t i = 0; i < n; i++)
                d[i] = res[i] + 2 * d[i - 1] - d[i - 2];
            break;
        case 3:
            for (int64_t i = 0; i < n; i++)
                d[i] = res[i] + 3 * d[i - 1] - 3 * d[i - 2] + d[i - 3];
            break;
        default:
            for (int64_t i = 0; i < n; i++)
                d[i] = res[i] + 4 * d[i - 1] - 6 * d[i - 2]
                       + 4 * d[i - 3] - d[i - 4];
        }
    } else if (sftype >= 32) {                 /* LPC */
        int order = (int)(sftype & 31) + 1;
        for (int i = 0; i < order; i++)
            out[i] = fb_read_signed(br, bps);
        int prec = (int)fb_read(br, 4) + 1;
        if (prec == 16) return -1;
        int shift = fb_read_signed(br, 5);
        if (shift < 0) return -1;
        int32_t coefs[FLAC_MAX_ORDER];
        for (int i = 0; i < order; i++)
            coefs[i] = fb_read_signed(br, prec);
        int32_t *res = scratch;
        if (decode_residual(br, blocksize, order, res)) return -1;
        int64_t n = blocksize - order;
        int32_t *d = out + order;
        for (int64_t i = 0; i < n; i++) {      /* lpc.c:1045 wide */
            int64_t sum = 0;
            for (int j = 0; j < order; j++)
                sum += (int64_t)coefs[j] * d[i - j - 1];
            d[i] = res[i] + (int32_t)(sum >> shift);
        }
    } else {
        return -1;                             /* reserved type */
    }
    if (br->overrun) return -1;
    if (wasted)
        for (int32_t i = 0; i < blocksize; i++)
            out[i] = (int32_t)((uint32_t)out[i] << wasted);
    return 0;
}

/* Decode frames from byte `pos` until EOF, output capacity, or
 * max_frames.  out receives interleaved int32 samples.
 *
 * state in/out (int64[4]):
 *   [0] byte position   (in: start of scan; out: resume point)
 *   [1] channels        (in: 0 = learn from first frame; out: learned)
 *   [2] values written this call (out)
 *   [3] stop reason     (out: 0 eof, 1 out-full, 2 max_frames)
 *
 * work: caller-provided scratch of at least
 * FLAC_MAX_CH*(FLAC_MAX_ORDER+FLAC_MAX_BLOCK) + FLAC_MAX_BLOCK int32s
 * (per-channel subframe buffers + residual scratch; caller-owned so
 * concurrent decodes on different threads never share state).
 *
 * Returns frames decoded this call, or -1 on a malformed frame (the
 * caller raises DecodeError). */
int64_t flac_decode_stream(const uint8_t *data, int64_t nbytes,
                           int stream_bps, int32_t *out,
                           int64_t cap_values, int64_t max_frames,
                           int32_t *work, int64_t *state) {
    int64_t pos = state[0];
    int channels_known = (int)state[1];
    int64_t written = 0;
    int64_t frames = 0;
    state[3] = 0;
    const int chstride = FLAC_MAX_ORDER + FLAC_MAX_BLOCK;
    int32_t *scratch = work + (int64_t)FLAC_MAX_CH * chstride;

    while (pos + 4 < nbytes) {
        if (!(data[pos] == 0xFF && (data[pos + 1] & 0xFC) == 0xF8)) {
            pos++;                             /* resync scan */
            continue;
        }
        fbits br;
        fb_init(&br, data, nbytes, pos * 8);
        fb_read(&br, 14);                      /* sync */
        fb_read(&br, 1);                       /* reserved */
        fb_read(&br, 1);                       /* blocking strategy */
        uint32_t bs_code = fb_read(&br, 4);
        uint32_t sr_code = fb_read(&br, 4);
        uint32_t ch_code = fb_read(&br, 4);
        uint32_t bps_code = fb_read(&br, 3);
        fb_read(&br, 1);                       /* reserved */
        if (fb_utf8_skip(&br)) return -1;
        int32_t blocksize = BLOCKSIZE_TAB[bs_code];
        if (blocksize == -1) blocksize = (int32_t)fb_read(&br, 8) + 1;
        else if (blocksize == -2) blocksize = (int32_t)fb_read(&br, 16) + 1;
        /* variable sample-rate codes: value unused, bits consumed
           (codes 0 and 15 read nothing: the stream rate) */
        if (sr_code == 12) fb_read(&br, 8);
        else if (sr_code == 13 || sr_code == 14) fb_read(&br, 16);
        int bps = BPS_TAB[bps_code];
        if (!bps) bps = stream_bps;
        fb_read(&br, 8);                       /* CRC-8 (not verified) */
        if (br.overrun) return -1;
        if (blocksize <= 0 || blocksize > FLAC_MAX_BLOCK) return -1;
        if (bps <= 0 || bps > 32) return -1;

        int channels, assign;                  /* 0 indep, 1 L/S, 2 R/S, 3 M/S */
        if (ch_code < 8) { channels = (int)ch_code + 1; assign = 0; }
        else if (ch_code == 8) { channels = 2; assign = 1; }
        else if (ch_code == 9) { channels = 2; assign = 2; }
        else if (ch_code == 10) { channels = 2; assign = 3; }
        else return -1;
        if (channels_known == 0) {
            channels_known = channels;
            state[1] = channels;
        } else if (channels != channels_known) {
            return -1;                         /* mid-stream layout change */
        }
        if (written + (int64_t)blocksize * channels > cap_values) {
            state[3] = 1;                      /* out full: resume here */
            break;
        }

        for (int c = 0; c < channels; c++) {
            int ebps = bps;
            if ((assign == 1 && c == 1) || (assign == 2 && c == 0)
                || (assign == 3 && c == 1))
                ebps += 1;                     /* side channel */
            if (ebps > 32)                     /* 33-bit side plane:
                                                  int32 buffers can't hold
                                                  it */
                return -1;
            if (decode_subframe(&br, blocksize, ebps,
                                work + c * chstride + FLAC_MAX_ORDER,
                                scratch))
                return -1;
        }
        fb_align(&br);
        fb_read(&br, 16);                      /* CRC-16 (not verified) */
        if (br.overrun) return -1;
        pos = (fb_tell(&br) + 7) / 8;

        int32_t *o = out + written;
        const int32_t *a = work + FLAC_MAX_ORDER;
        const int32_t *b = work + chstride + FLAC_MAX_ORDER;
        switch (assign) {
        case 1:                                /* left/side */
            for (int32_t i = 0; i < blocksize; i++) {
                o[2 * i] = a[i];
                o[2 * i + 1] = (int32_t)((int64_t)a[i] - b[i]);
            }
            break;
        case 2:                                /* right/side */
            for (int32_t i = 0; i < blocksize; i++) {
                o[2 * i] = (int32_t)((int64_t)a[i] + b[i]);
                o[2 * i + 1] = b[i];
            }
            break;
        case 3:                                /* mid/side */
            for (int32_t i = 0; i < blocksize; i++) {
                int64_t mid = ((int64_t)a[i] << 1) | (b[i] & 1);
                o[2 * i] = (int32_t)((mid + b[i]) >> 1);
                o[2 * i + 1] = (int32_t)((mid - b[i]) >> 1);
            }
            break;
        default:
            for (int32_t i = 0; i < blocksize; i++)
                for (int c = 0; c < channels; c++)
                    o[(int64_t)i * channels + c] =
                        work[c * chstride + FLAC_MAX_ORDER + i];
        }
        written += (int64_t)blocksize * channels;
        frames++;
        if (max_frames > 0 && frames >= max_frames) {
            state[3] = 2;
            break;
        }
    }
    state[0] = pos;
    state[2] = written;
    return frames;
}
