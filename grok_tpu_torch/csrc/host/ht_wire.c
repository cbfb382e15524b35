/* HT cleanup-segment wire transforms (ISO/IEC 15444-15 structure).
 *
 * The port's copy of grok_tpu/native/ht_wire.c: C mirrors of the Python
 * oracle in grok_tpu/t1ht/scalar.py (assemble_cleanup, _finish_raw and
 * the wire readers) for the device paths:
 *
 *   - grk_ht_scan2_bits: batch wire -> clean split (the serving
 *     decode's staging step: parse framing, un-stuff all three
 *     sub-streams into a digest buffer the device gathers from), with
 *     each sub-stream's clean bits (the port's addition to the JAX
 *     package's grk_ht_scan2).
 *   - grk_ht_assemble_batch: batch clean -> wire assembly (the serving
 *     encode's final step over the downloaded device streams).
 *   - grk_ht_raw_batch: batch clean -> wire stuffing of the HT SigProp
 *     and HT MagRef segments (the refined encode).
 *   - grk_ht_unstuff_batch_bits: batch wire -> clean un-stuffing of
 *     those segments (the general decode route's staging; the port's
 *     own addition, byte-identical to grok_tpu/t1ht/wire.py
 *     _unstuff_lsb).
 *
 * Byte-identity with the JAX package's copy is held by
 * tests/test_torch_host.py; see grok_tpu/t1ht/scalar.py for the wire
 * layout.
 * Reference parity: [grok: src/lib/core/t1/t1_ht/] (SURVEY.md §2 row 8).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint8_t REV8[256] = {
#define R2(n) n, n + 2 * 64, n + 1 * 64, n + 3 * 64
#define R4(n) R2(n), R2(n + 2 * 16), R2(n + 1 * 16), R2(n + 3 * 16)
#define R6(n) R4(n), R4(n + 2 * 4), R4(n + 1 * 4), R4(n + 3 * 4)
    R6(0), R6(2), R6(1), R6(3)
#undef R2
#undef R4
#undef R6
};

/* ---- bit sinks over clean LSB-first buffers ---------------------------- */

typedef struct {
    uint8_t *out;
    long long n;        /* bytes emitted */
    uint64_t acc;
    int nb;
} sink_t;

static inline void sink_bits(sink_t *s, uint32_t v, int nbits)
{
    s->acc |= (uint64_t)(v & ((1u << nbits) - 1u)) << s->nb;
    s->nb += nbits;
    while (s->nb >= 8) {
        s->out[s->n++] = (uint8_t)(s->acc & 0xFF);
        s->acc >>= 8;
        s->nb -= 8;
    }
}

static inline long long sink_flush(sink_t *s)
{
    if (s->nb) {
        s->out[s->n++] = (uint8_t)(s->acc & 0xFF);
        s->acc = 0;
        s->nb = 0;
    }
    return s->n;
}

/* ---- clean -> wire (stuffing; sequential in the emitted bytes) --------- */

static inline int clean_bit(const uint8_t *b, long long i)
{
    return (b[i >> 3] >> (i & 7)) & 1;
}

/* take the next `cap` clean bits starting at *i (zero-padded past nbits) */
static inline uint32_t take_bits(const uint8_t *buf, long long nbits,
                                 long long *i, int cap)
{
    uint32_t v = 0;
    for (int k = 0; k < cap; k++) {
        if (*i + k < nbits)
            v |= (uint32_t)clean_bit(buf, *i + k) << k;
    }
    *i += cap;
    return v;
}

static long long stuff_lsb(const uint8_t *buf, long long nbits, uint8_t *out)
{
    long long n = 0, i = 0;
    int cap = 8;
    while (i < nbits) {
        uint32_t v = take_bits(buf, nbits, &i, cap);
        out[n++] = (uint8_t)v;
        cap = (out[n - 1] == 0xFF) ? 7 : 8;
    }
    return n;
}

static long long stuff_msb(const uint8_t *buf, long long nbits, uint8_t *out)
{
    long long n = 0, i = 0;
    int cap = 8;
    while (i < nbits) {
        uint32_t v = take_bits(buf, nbits, &i, cap);
        out[n++] = (uint8_t)(REV8[v] >> (8 - cap));
        cap = (out[n - 1] == 0xFF) ? 7 : 8;
    }
    return n;
}

/* clean VLC bits -> (first nibble, body in backward-emission order) */
static long long vlc_back(const uint8_t *buf, long long nbits,
                          uint8_t *out, int *nib_out)
{
    long long i = 0;
    int nib = (int)take_bits(buf, nbits, &i, 4);
    long long n = 0;
    int prev_gt = nib >= 0x9;
    while (i < nbits) {
        long long save = i;
        uint32_t acc = take_bits(buf, nbits, &i, 7);
        if (prev_gt && acc == 0x7F) {
            out[n++] = 0x7F;
        } else {
            i = save;
            acc = take_bits(buf, nbits, &i, 8);
            out[n++] = (uint8_t)acc;
        }
        prev_gt = out[n - 1] > 0x8F;
    }
    *nib_out = nib;
    return n;
}

/* Assemble one wire cleanup segment from clean streams; returns the
 * segment length, or -1 on scup overflow / -2 on capacity overflow.
 * Mirrors t1ht.scalar.assemble_cleanup byte for byte. */
static long long assemble_one(const uint8_t *ms, long long msbits,
                              const uint8_t *mel, long long melbits,
                              const uint8_t *vlc, long long vlcbits,
                              uint8_t *out, long long cap,
                              uint8_t *tmp /* >= melbits/7 + vlcbits/7 + 8 */)
{
    long long worst = 1 + msbits / 7 + melbits / 7 + vlcbits / 7 + 16;
    if (worst > cap)
        return -2;
    long long ms_n = stuff_lsb(ms, msbits, out);
    uint8_t *melw = tmp;
    long long mel_n = stuff_msb(mel, melbits, melw);
    uint8_t *vb = tmp + mel_n;
    int nib;
    long long vn = vlc_back(vlc, vlcbits, vb, &nib);

    long long pad = 0, scup;
    int b_l2, b_l1;
    for (;;) {
        scup = mel_n + pad + vn + 2;
        if (scup > 4079)
            return -1;
        b_l2 = (nib << 4) | (int)(scup & 0xF);
        b_l1 = (int)(scup >> 4);
        if (b_l2 == 0xFF && b_l1 > 0x8F) {
            pad++;
            continue;
        }
        int first_vlc = vn ? vb[vn - 1] : b_l2;
        if (mel_n && pad == 0 && melw[mel_n - 1] == 0xFF
                && first_vlc > 0x8F) {
            pad++;
            continue;
        }
        break;
    }
    int first_suffix = mel_n ? melw[0]
                     : (pad ? 0x00 : (vn ? vb[vn - 1] : b_l2));
    if (ms_n && out[ms_n - 1] == 0xFF && first_suffix > 0x8F)
        out[ms_n++] = 0x00;

    long long pos = ms_n;
    if (pos + scup > cap)
        return -2;
    memcpy(out + pos, melw, (size_t)mel_n);
    pos += mel_n;
    memset(out + pos, 0, (size_t)pad);
    pos += pad;
    for (long long j = vn - 1; j >= 0; j--)
        out[pos++] = vb[j];
    out[pos++] = (uint8_t)b_l2;
    out[pos++] = (uint8_t)b_l1;
    return pos;
}

/* Batch assembly: stream k's clean bytes live in buf at byte offsets
 * *_off[k] with *_bits[k] bits; segments are written back-to-back into
 * out, olens[k] = segment length (0 when pvals[k] < 0: skipped lane).
 * Returns 0, or 1 on any overflow. */
int grk_ht_assemble_batch(const uint8_t *buf,
                          const long long *ms_off, const long long *ms_bits,
                          const long long *mel_off, const long long *mel_bits,
                          const long long *vlc_off, const long long *vlc_bits,
                          const int *pvals, int n,
                          uint8_t *out, long long ocap, long long *olens)
{
    long long pos = 0;
    long long tcap = 0;
    uint8_t *tmp = NULL;
    for (int k = 0; k < n; k++) {
        olens[k] = 0;
        if (pvals[k] < 0)
            continue;
        long long need = mel_bits[k] / 7 + vlc_bits[k] / 7 + 64;
        if (need > tcap) {
            free(tmp);
            tcap = need * 2;
            tmp = (uint8_t *)malloc((size_t)tcap);
            if (!tmp)
                return 1;
        }
        long long r = assemble_one(buf + ms_off[k], ms_bits[k],
                                   buf + mel_off[k], mel_bits[k],
                                   buf + vlc_off[k], vlc_bits[k],
                                   out + pos, ocap - pos, tmp);
        if (r < 0) {
            free(tmp);
            return 1;
        }
        olens[k] = r;
        pos += r;
    }
    free(tmp);
    return 0;
}

/* Stuff n raw (HT SigProp / HT MagRef) streams: clean LSB-first bits ->
 * wire bytes with 0xFF stuffing and a guaranteed non-0xFF final byte
 * (t1ht.scalar._finish_raw).  Streams are written back-to-back into
 * out; olens[k] = wire length.  Returns 0, or 1 on capacity overflow. */
int grk_ht_raw_batch(const uint8_t *buf, const long long *off,
                     const long long *bits, int n,
                     uint8_t *out, long long ocap, long long *olens)
{
    long long pos = 0;
    for (int k = 0; k < n; k++) {
        long long worst = bits[k] / 7 + 8;
        if (pos + worst > ocap)
            return 1;
        long long m = stuff_lsb(buf + off[k], bits[k], out + pos);
        if (m && out[pos + m - 1] == 0xFF)
            out[pos + m++] = 0x00;
        olens[k] = m;
        pos += m;
    }
    return 0;
}

/* ---- wire -> clean (un-stuffing; pointwise in the wire bytes) ---------- */

/* Un-stuff n raw forward LSB-first segments (HT SigProp / HT MagRef) at
 * body[off[i] .. off[i]+len[i]): a byte following 0xFF carries 7 payload
 * bits.  The clean bytes go back-to-back into out, the last byte of each
 * zero-padded; olens[i] = clean length, and obits[i] = its clean bits,
 * where a reader's 1-bits past the segment begin.
 * Byte-identical to t1ht/wire.py _unstuff_lsb.  Returns 0, or 1 if a
 * segment lies outside the body or out would overflow (ocap >= sum(len)
 * suffices). */
int grk_ht_unstuff_batch_bits(const uint8_t *body, long long blen,
                              const long long *off, const int *len, int n,
                              uint8_t *out, long long ocap, long long *olens,
                              long long *obits)
{
    long long d = 0;
    for (int i = 0; i < n; i++) {
        long long o = off[i];
        long long L = len[i];
        if (o < 0 || L < 0 || o + L > blen || d + L > ocap)
            return 1;
        sink_t s = { out + d, 0, 0, 0 };
        int prev_ff = 0;
        long long nbits = 0;
        for (long long j = 0; j < L; j++) {
            int b = body[o + j];
            if (prev_ff)
                sink_bits(&s, (uint32_t)(b & 0x7F), 7);
            else
                sink_bits(&s, (uint32_t)b, 8);
            nbits += prev_ff ? 7 : 8;
            prev_ff = (b == 0xFF);
        }
        olens[i] = sink_flush(&s);
        obits[i] = nbits;
        d += olens[i];
    }
    return 0;
}

/* The word path loads 8 wire bytes as one little-endian word; elsewhere
 * the MagSgn un-stuff keeps to the byte rule. */
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
#define HT_WORD_UNSTUFF 1
#else
#define HT_WORD_UNSTUFF 0
#endif

#define ONES8 0x0101010101010101ULL
#define HIGH8 0x8080808080808080ULL
#define LOW7 0x7F7F7F7F7F7F7F7FULL
#define MID3 0x7070707070707070ULL
#define EVEN16 0x00FF00FF00FF00FFULL

/* MagSgn un-stuff, a word at a time: an 8-byte word with no 0xFF that
 * follows a byte other than 0xFF carries 64 payload bits, appended to a
 * 64-bit accumulator of fewer than 8 pending bits with one shift-or and
 * one 8-byte store of whole clean bytes.  Every other word, and the tail
 * under 8 bytes, takes the byte rule (7 payload bits after 0xFF, else 8).
 * The final partial byte is flushed zero-padded.  Returns the clean
 * bytes written to out; *nbits gets the clean bits, *wbytes the wire
 * bytes the word path took. */
static long long unstuff_ms(const uint8_t *seg, long long len, uint8_t *out,
                            long long *nbits, long long *wbytes)
{
    sink_t s = { out, 0, 0, 0 };    /* s.nb < 8 between wire bytes */
    long long j = 0, bits = 8 * len, words = 0;
    int prev_ff = 0;
    while (j < len) {
        long long end = len;
        if (HT_WORD_UNSTUFF && j + 8 <= len) {
            uint64_t w;
            memcpy(&w, seg + j, 8);
            uint64_t x = ~w;    /* a 0xFF byte of w is a zero byte of x */
            if (!prev_ff && !((x - ONES8) & w & HIGH8)) {
                uint64_t lo = s.acc | (w << s.nb);
                memcpy(s.out + s.n, &lo, 8);
                s.n += 8;
                s.acc = s.nb ? w >> (64 - s.nb) : 0;
                j += 8;
                words += 8;
                continue;
            }
            end = j + 8;
        }
        for (; j < end; j++) {
            int b = seg[j];
            sink_bits(&s, (uint32_t)b, prev_ff ? 7 : 8);
            bits -= prev_ff;
            prev_ff = b == 0xFF;
        }
    }
    *nbits = bits;
    *wbytes = words;
    return sink_flush(&s);
}

/* 0x80 in each byte of w that is zero, 0 elsewhere (exact per byte) */
static inline uint64_t zero_bytes(uint64_t w)
{
    return ~(((w & LOW7) + LOW7) | w | LOW7);
}

/* the sum of the 8 byte lanes of c */
static inline int lane_sum(uint64_t c)
{
    c = (c & EVEN16) + ((c >> 8) & EVEN16);
    return (int)((c * 0x0001000100010001ULL) >> 48);
}

/* Over seg[j0 .. e): add the 0xFF bytes to *nff, the 0x7F bytes to *n7f
 * and the 0x7F bytes followed by a byte > 0x8F (seg[e] included) to
 * *pairs.  Eight bytes a step into byte-lane counters, summed every 255
 * steps, before a lane could overflow; the tail under 8 bytes by the
 * byte rule. */
static void suffix_counts(const uint8_t *seg, long long j0, long long e,
                          int *nff, int *n7f, int *pairs)
{
    long long j = j0;
    while (j + 8 <= e) {
        long long stop = e - j > 8 * 255 ? j + 8 * 255 : e;
        uint64_t cf = 0, c7 = 0, cp = 0;
        for (; j + 8 <= stop; j += 8) {
            uint64_t w, v;
            memcpy(&w, seg + j, 8);
            memcpy(&v, seg + j + 1, 8);
            uint64_t f7 = zero_bytes(w ^ LOW7);
            cf += zero_bytes(~w) >> 7;
            c7 += f7 >> 7;
            cp += (f7 & v & ((v & MID3) + MID3)) >> 7;   /* v > 0x8F */
        }
        *nff += lane_sum(cf);
        *n7f += lane_sum(c7);
        *pairs += lane_sum(cp);
    }
    for (; j < e; j++) {
        int is7f = seg[j] == 0x7F;
        *nff += seg[j] == 0xFF;
        *n7f += is7f;
        *pairs += is7f & (seg[j + 1] > 0x8F);
    }
}

/* Scan n cleanup segments at body[off[i] .. off[i]+len[i]): un-stuff
 * the MagSgn stream into clean LSB-first bytes appended to digest and
 * copy the raw SUFFIX (MEL+VLC+Scup region) verbatim after it — the
 * suffix is un-stuffed ON DEVICE (pipeline/device.py) so its bytes
 * cross the host link exactly once.  out7[i*7 + 0..6] =
 * (ok, ms_off, ms_len, suf_off, suf_len, n_ff, n_7f); ok = 0 for a
 * valid framing, -1 otherwise.  bits3[i*3 + 0..2] =
 * the clean bits of the MagSgn, MEL and VLC streams as the scalar
 * readers of t1ht/scalar.py take them (MEL forward up to byte L - 2,
 * VLC backward from the high nibble of byte L - 2 down to the suffix's
 * first byte), past which they read 1-bits.  Returns 0, or 1 if digest
 * capacity dcap would overflow (caller sizes dcap >= sum(2*len + 24)).
 * *dused gets the digest bytes written, *wbytes the MagSgn wire bytes
 * the word path of unstuff_ms took. */
int grk_ht_scan2_bits(const uint8_t *body, long long blen,
                      const long long *off, const int *len, int n,
                      int *out7, uint8_t *digest, long long dcap,
                      long long *dused, int *bits3, long long *wbytes)
{
    long long d = 0, words = 0;
    for (int i = 0; i < n; i++) {
        long long o = off[i];
        long long L = len[i];
        int *r = out7 + 7 * (long long)i;
        int *b3 = bits3 + 3 * (long long)i;
        r[0] = -1;
        r[1] = r[2] = r[3] = r[4] = r[5] = r[6] = 0;
        b3[0] = b3[1] = b3[2] = 0;
        if (o < 0 || L < 2 || o + L > blen)
            continue;
        const uint8_t *seg = body + o;
        int scup = (seg[L - 1] << 4) | (seg[L - 2] & 0xF);
        if (scup < 2 || scup > L)
            continue;
        long long suf = L - scup;
        if (d + 2 * L + 24 > dcap)
            return 1;

        long long ms_bits, wb;
        r[1] = (int)d;
        r[2] = (int)unstuff_ms(seg, suf, digest + d, &ms_bits, &wb);
        d += r[2];
        words += wb;

        /* raw suffix, verbatim (device un-stuffs MEL forward and VLC
         * backward from it); count the stuffing events so the device
         * repack can size its shift-candidate set statically.  One pass
         * over seg[suf .. L-2) takes the 0xFF and 0x7F counts, and the
         * pairs 0x7F, > 0x8F that the VLC reader takes 7 bits from; the
         * MEL reader takes 7 bits after each 0xFF in seg[suf .. L-4]. */
        memcpy(digest + d, seg + suf, (size_t)scup);
        int nff = 0, n7f = 0, pairs = 0;
        suffix_counts(seg, suf, L - 2, &nff, &n7f, &pairs);
        int mel_ff = nff - (L - 3 >= suf && seg[L - 3] == 0xFF);
        long long body_bits = 8 * (L - 2 - suf);
        nff += (seg[L - 2] == 0xFF) + (seg[L - 1] == 0xFF);
        n7f += (seg[L - 2] == 0x7F) + (seg[L - 1] == 0x7F);
        r[3] = (int)d;
        r[4] = (int)scup;
        r[5] = nff;
        r[6] = n7f;
        d += scup;
        r[0] = 0;
        b3[0] = (int)ms_bits;
        b3[1] = (int)(body_bits - mel_ff);
        b3[2] = (int)(4 + body_bits - pairs);
    }
    *dused = d;
    *wbytes = words;
    return 0;
}
