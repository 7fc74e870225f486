/* Native Ogg demux + Opus packet scan: the container half of the Opus
 * host hot path.
 *
 * One pass over the physical stream emits the per-frame feed that
 * celt_decode_stream consumes (payload bytes + offsets + frame sizes +
 * end bands + coded channels), replacing the Python page walk and
 * packet split (formats/ogg.py demux + formats/opus/packet.py
 * parse_packet) for the common case of a single CELT-only stream.
 * The Python path remains the general/fallback route (chained streams,
 * SILK/hybrid packets, CRC verification).
 *
 * Functional equivalent of libogg's framing + opusfile's packet feed
 * (reference: third_party/libogg/src/framing.c,
 * third_party/opus/opusfile/src/opusfile.c op_fetch_and_process_page;
 * TOC split: third_party/opus/libopus/src/opus.c
 * opus_packet_parse_impl).  Implemented from the Ogg page structure
 * (RFC 3533) and the Opus TOC rules (RFC 6716 section 3).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* bandwidth code from TOC, CELT-only packets (toc & 0x80):
 *   (toc >> 5) & 3: 0 -> NB(end 13), 1 -> WB(17), 2 -> SWB(19),
 *   3 -> FB(21).  Matches packet_bandwidth + _endband_for_bandwidth
 * (MEDIUMBAND folds to NARROWBAND for CELT). */
static const int32_t celt_endband[4] = {13, 17, 19, 21};

/* samples per frame at 48 kHz for a CELT-only toc */
static int celt_frame_size(uint8_t toc) {
    return (48000 << ((toc >> 3) & 0x3)) / 400;
}

/* 1- or 2-byte frame length (RFC 6716 sec 3.2.1); returns -1 on
 * truncation, advances *pos. */
static int parse_size(const uint8_t *d, int64_t n, int64_t *pos) {
    int b, v;
    if (*pos >= n) return -1;
    b = d[(*pos)++];
    if (b < 252) return b;
    if (*pos >= n) return -1;
    v = 4 * d[(*pos)++] + b;
    return v;
}

typedef struct {
    uint8_t *payload;
    int64_t payload_cap, payload_len;
    int64_t *offs, *lens;
    int32_t *fsz, *ends, *chs;
    int64_t max_frames, n_frames;
} feed;

static int emit_frame(feed *F, const uint8_t *src, int64_t sz,
                      int32_t fs, int32_t end, int32_t ch) {
    if (F->n_frames >= F->max_frames) return -2;
    if (F->payload_len + sz > F->payload_cap) return -2;
    memcpy(F->payload + F->payload_len, src, (size_t)sz);
    F->offs[F->n_frames] = F->payload_len;
    F->lens[F->n_frames] = sz;
    F->fsz[F->n_frames] = fs;
    F->ends[F->n_frames] = end;
    F->chs[F->n_frames] = ch;
    F->payload_len += sz;
    F->n_frames++;
    return 0;
}

/* Split one Opus packet into frames and emit them.  Returns 0, or
 * -3 (malformed), -4 (not CELT-only), -2 (capacity). */
static int split_packet(feed *F, const uint8_t *d, int64_t n) {
    uint8_t toc;
    int code, fs, end, ch, count, i, rc;
    int64_t pos = 1, padding = 0, avail, sz, last;
    int sizes[48];
    if (n < 1) return 0;            /* empty packet: nothing to decode */
    toc = d[0];
    if (!(toc & 0x80)) return -4;   /* SILK or hybrid: general path */
    fs = celt_frame_size(toc);
    end = celt_endband[(toc >> 5) & 0x3];
    ch = (toc & 0x4) ? 2 : 1;
    code = toc & 0x3;
    if (code == 0) {
        return emit_frame(F, d + 1, n - 1, fs, end, ch);
    }
    if (code == 1) {
        if ((n - 1) & 1) return -3;
        sz = (n - 1) >> 1;
        rc = emit_frame(F, d + 1, sz, fs, end, ch);
        if (rc) return rc;
        return emit_frame(F, d + 1 + sz, sz, fs, end, ch);
    }
    if (code == 2) {
        sz = parse_size(d, n, &pos);
        if (sz < 0 || sz > n - pos) return -3;
        rc = emit_frame(F, d + pos, sz, fs, end, ch);
        if (rc) return rc;
        return emit_frame(F, d + pos + sz, n - pos - sz, fs, end, ch);
    }
    /* code 3 */
    if (n - pos < 1) return -3;
    {
        uint8_t cbyte = d[pos++];
        count = cbyte & 0x3F;
        if (count <= 0 || fs * count > 5760) return -3;
        if (cbyte & 0x40) {         /* padding */
            for (;;) {
                int p;
                if (pos >= n) return -3;
                p = d[pos++];
                padding += (p < 255) ? p : 254;
                if (p != 255) break;
            }
        }
        avail = n - pos - padding;
        if (avail < 0) return -3;
        if (cbyte & 0x80) {         /* VBR */
            int64_t total = 0;
            for (i = 0; i < count - 1; i++) {
                sz = parse_size(d, n, &pos);
                if (sz < 0) return -3;
                sizes[i] = (int)sz;
                total += sz;
            }
            last = n - pos - padding - total;
            if (last < 0) return -3;
            sizes[count - 1] = (int)last;
        }
        else {                      /* CBR */
            if (avail % count) return -3;
            sz = avail / count;
            for (i = 0; i < count; i++) sizes[i] = (int)sz;
        }
        for (i = 0; i < count; i++) {
            if (sizes[i] > n - pos) return -3;
            rc = emit_frame(F, d + pos, sizes[i], fs, end, ch);
            if (rc) return rc;
            pos += sizes[i];
        }
    }
    return 0;
}

#define PARTIAL_CAP (1 << 20)

/* Scan `data` for the first Opus logical stream (bos packet starting
 * with "OpusHead") and emit the CELT frame feed.
 *
 * Returns n_frames >= 0, or:
 *   -1 no Opus stream found          -2 output capacity exceeded
 *   -3 malformed packet              -4 non-CELT packet (general path)
 *   -5 packet exceeds partial buffer
 *
 * info_out[8]: channels, preskip, input_rate, gain_q8, mapping_family,
 *              serial, n_packets, last_granule_lo48 (clamped >= 0)
 */
static int64_t scan_impl(
    const uint8_t *data, int64_t len,
    uint8_t *payload_out, int64_t payload_cap,
    int64_t *offs, int64_t *lens,
    int32_t *fsz, int32_t *ends, int32_t *chs,
    int64_t max_frames, int32_t *info_out, uint8_t *partial)
{
    feed F;
    static const uint8_t oggs[4] = {'O', 'g', 'g', 'S'};
    int64_t partial_len = 0;
    int partial_open = 0;
    int have_serial = 0, header_pkts = 0, done = 0;
    uint32_t serial = 0;
    int64_t pos = 0, n_packets = 0;
    int64_t last_granule = -1;
    int64_t last_seq = -1;

    F.payload = payload_out;
    F.payload_cap = payload_cap;
    F.payload_len = 0;
    F.offs = offs;
    F.lens = lens;
    F.fsz = fsz;
    F.ends = ends;
    F.chs = chs;
    F.max_frames = max_frames;
    F.n_frames = 0;

    while (pos + 27 <= len && !done) {
        uint8_t htype, nsegs;
        uint32_t pserial;
        int64_t granule, lacing_at, body_at, body_len, i;
        const uint8_t *lacing;
        /* resync to "OggS" */
        while (pos + 27 <= len && memcmp(data + pos, oggs, 4))
            pos++;
        if (pos + 27 > len) break;
        htype = data[pos + 5];
        memcpy(&granule, data + pos + 6, 8);
        memcpy(&pserial, data + pos + 14, 4);
        nsegs = data[pos + 26];
        lacing_at = pos + 27;
        if (lacing_at + nsegs > len) break;
        lacing = data + lacing_at;
        body_at = lacing_at + nsegs;
        body_len = 0;
        for (i = 0; i < nsegs; i++) body_len += lacing[i];
        if (body_at + body_len > len) break;

        if (!have_serial) {
            /* candidate bos page: first segment must open OpusHead */
            if ((htype & 0x02) && nsegs >= 1 && lacing[0] >= 8
                && !memcmp(data + body_at, "OpusHead", 8)) {
                have_serial = 1;
                serial = pserial;
            }
            else {
                pos = body_at + body_len;
                continue;
            }
        }
        if (pserial != serial) {     /* multiplexed foreign stream */
            pos = body_at + body_len;
            continue;
        }
        if (granule >= 0 && granule > last_granule)
            last_granule = granule;
        {
            /* page-sequence gap = lost pages: the fast path has no
               concealment, so hand such streams to the general path
               (formats/ogg.py flags the hole; the decoder conceals) */
            uint32_t pseq;
            memcpy(&pseq, data + pos + 18, 4);
            if (last_seq >= 0 && (int64_t)pseq > last_seq + 1)
                return -4;
            if ((int64_t)pseq > last_seq) last_seq = (int64_t)pseq;
        }

        if (!(htype & 0x01) && partial_open) {
            partial_len = 0;         /* hole: drop the partial packet */
            partial_open = 0;
        }
        i = 0;
        if ((htype & 0x01) && !partial_open) {
            /* orphaned continuation: skip through its last segment */
            for (; i < nsegs; i++)
                if (lacing[i] < 255) { i++; break; }
            if (i == nsegs && (nsegs == 0 || lacing[nsegs - 1] == 255)) {
                pos = body_at + body_len;
                continue;
            }
        }
        {
            int64_t off = body_at;
            int64_t j;
            for (j = 0; j < i; j++) off += lacing[j];
            for (; i < nsegs; i++) {
                int64_t lace = lacing[i];
                if (partial_len + lace > PARTIAL_CAP) return -5;
                memcpy(partial + partial_len, data + off, (size_t)lace);
                partial_len += lace;
                partial_open = 1;
                off += lace;
                if (lace < 255) {    /* packet complete */
                    int rc = 0;
                    if (header_pkts == 0) {
                        /* OpusHead (RFC 7845 sec 5.1) */
                        if (partial_len < 19
                            || memcmp(partial, "OpusHead", 8))
                            return -3;
                        info_out[0] = partial[9];            /* channels */
                        info_out[1] = (int32_t)(partial[10]
                                      | ((int32_t)partial[11] << 8));
                        memcpy(&info_out[2], partial + 12, 4); /* rate */
                        info_out[3] = (int32_t)(int16_t)(partial[16]
                                      | ((int32_t)partial[17] << 8));
                        info_out[4] = partial[18];   /* mapping family */
                        if (info_out[4] != 0) return -4; /* multistream:
                                                            general path */
                        header_pkts = 1;
                    }
                    else if (header_pkts == 1) {
                        header_pkts = 2;             /* OpusTags: skip */
                    }
                    else {
                        rc = split_packet(&F, partial, partial_len);
                        n_packets++;
                    }
                    partial_len = 0;
                    partial_open = 0;
                    if (rc) return rc;
                    if ((htype & 0x04) && i == nsegs - 1)
                        done = 1;    /* eos: ignore chained streams */
                }
            }
        }
        pos = body_at + body_len;
    }
    if (!have_serial) return -1;
    info_out[5] = (int32_t)serial;
    info_out[6] = (int32_t)n_packets;
    info_out[7] = (int32_t)(last_granule >= 0
                            ? (last_granule & 0x7FFFFFFF) : -1);
    return F.n_frames;
}

int64_t ogg_opus_celt_scan(
    const uint8_t *data, int64_t len,
    uint8_t *payload_out, int64_t payload_cap,
    int64_t *offs, int64_t *lens,
    int32_t *fsz, int32_t *ends, int32_t *chs,
    int64_t max_frames, int32_t *info_out)
{
    /* heap, not stack: 1 MB and this runs on worker threads */
    uint8_t *partial = (uint8_t *)malloc(PARTIAL_CAP);
    int64_t r;
    if (!partial) return -5;
    r = scan_impl(data, len, payload_out, payload_cap, offs, lens,
                  fsz, ends, chs, max_frames, info_out, partial);
    free(partial);
    return r;
}

/* Generic Ogg packet collector: assemble every packet of the first
 * logical stream whose FIRST packet starts with `magic`, with the same
 * hole/orphan semantics as formats/ogg.py demux.  Serves the Vorbis
 * (and general Opus) paths; TOC-free.
 *
 * Returns n_packets, or -1 (no match), -2 (capacity), -5 (partial
 * overflow).  info_out[3]: last_granule_lo63 (>=0 clamp, -1 none),
 * more_streams (another bos page with the same magic exists after this
 * stream started: chained file -> caller uses the Python path), serial.
 */
int64_t ogg_collect_packets(
    const uint8_t *data, int64_t len,
    const uint8_t *magic, int magic_len,
    uint8_t *payload_out, int64_t payload_cap,
    int64_t *offs, int64_t *lens, int64_t max_packets,
    int64_t *info_out)
{
    static const uint8_t oggs[4] = {'O', 'g', 'g', 'S'};
    uint8_t *partial = (uint8_t *)malloc(PARTIAL_CAP);
    int64_t partial_len = 0;
    int partial_open = 0;
    int have_serial = 0;
    uint32_t serial = 0;
    int64_t pos = 0, n_packets = 0;
    int64_t last_granule = -1;
    int64_t more = 0;

    if (!partial) return -5;
#define OUT(v) do { free(partial); return (v); } while (0)

    while (pos + 27 <= len) {
        uint8_t htype, nsegs;
        uint32_t pserial;
        int64_t granule, lacing_at, body_at, body_len, i;
        const uint8_t *lacing;
        while (pos + 27 <= len && memcmp(data + pos, oggs, 4))
            pos++;
        if (pos + 27 > len) break;
        htype = data[pos + 5];
        memcpy(&granule, data + pos + 6, 8);
        memcpy(&pserial, data + pos + 14, 4);
        nsegs = data[pos + 26];
        lacing_at = pos + 27;
        if (lacing_at + nsegs > len) break;
        lacing = data + lacing_at;
        body_at = lacing_at + nsegs;
        body_len = 0;
        for (i = 0; i < nsegs; i++) body_len += lacing[i];
        if (body_at + body_len > len) break;

        if ((htype & 0x02) && nsegs >= 1
            && lacing[0] >= (uint8_t)magic_len
            && !memcmp(data + body_at, magic, (size_t)magic_len)) {
            if (!have_serial) {
                have_serial = 1;
                serial = pserial;
            }
            else if (pserial != serial) {
                more = 1;       /* chained: second matching stream */
                pos = body_at + body_len;
                continue;
            }
        }
        if (!have_serial || pserial != serial) {
            pos = body_at + body_len;
            continue;
        }
        if (granule >= 0 && granule > last_granule)
            last_granule = granule;

        if (!(htype & 0x01) && partial_open) {
            partial_len = 0;
            partial_open = 0;
        }
        i = 0;
        if ((htype & 0x01) && !partial_open) {
            for (; i < nsegs; i++)
                if (lacing[i] < 255) { i++; break; }
            if (i == nsegs && (nsegs == 0 || lacing[nsegs - 1] == 255)) {
                pos = body_at + body_len;
                continue;
            }
        }
        {
            int64_t off = body_at;
            int64_t j;
            for (j = 0; j < i; j++) off += lacing[j];
            for (; i < nsegs; i++) {
                int64_t lace = lacing[i];
                if (partial_len + lace > PARTIAL_CAP) OUT(-5);
                memcpy(partial + partial_len, data + off, (size_t)lace);
                partial_len += lace;
                partial_open = 1;
                off += lace;
                if (lace < 255) {
                    if (n_packets >= max_packets) OUT(-2);
                    {
                        int64_t at = n_packets
                            ? offs[n_packets - 1] + lens[n_packets - 1]
                            : 0;
                        if (at + partial_len > payload_cap) OUT(-2);
                        memcpy(payload_out + at, partial,
                               (size_t)partial_len);
                        offs[n_packets] = at;
                        lens[n_packets] = partial_len;
                        n_packets++;
                    }
                    partial_len = 0;
                    partial_open = 0;
                }
            }
        }
        pos = body_at + body_len;
    }
    if (!have_serial) OUT(-1);
    info_out[0] = last_granule >= 0 ? last_granule : -1;
    info_out[1] = more;
    info_out[2] = (int64_t)serial;
    free(partial);
    return n_packets;
#undef OUT
}
