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
    uint32_t acc;
    int nb;
} sink_t;

static inline void sink_bits(sink_t *s, uint32_t v, int nbits)
{
    s->acc |= (v & ((1u << nbits) - 1u)) << s->nb;
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
 * *dused gets the digest bytes written. */
int grk_ht_scan2_bits(const uint8_t *body, long long blen,
                      const long long *off, const int *len, int n,
                      int *out7, uint8_t *digest, long long dcap,
                      long long *dused, int *bits3)
{
    long long d = 0;
    for (int i = 0; i < n; i++) {
        long long o = off[i];
        long long L = len[i];
        int *r = out7 + 7 * (long long)i;
        r[0] = -1;
        r[1] = r[2] = r[3] = r[4] = r[5] = r[6] = 0;
        bits3[3 * (long long)i] = bits3[3 * (long long)i + 1]
            = bits3[3 * (long long)i + 2] = 0;
        if (o < 0 || L < 2 || o + L > blen)
            continue;
        const uint8_t *seg = body + o;
        int scup = (seg[L - 1] << 4) | (seg[L - 2] & 0xF);
        if (scup < 2 || scup > L)
            continue;
        long long suf = L - scup;
        if (d + 2 * L + 24 > dcap)
            return 1;

        /* MagSgn: forward LSB-first, 7 payload bits after 0xFF */
        sink_t s = { digest + d, 0, 0, 0 };
        int prev_ff = 0;
        long long ms_bits = 0;
        for (long long j = 0; j < suf; j++) {
            int b = seg[j];
            if (prev_ff)
                sink_bits(&s, (uint32_t)(b & 0x7F), 7);
            else
                sink_bits(&s, (uint32_t)b, 8);
            ms_bits += prev_ff ? 7 : 8;
            prev_ff = (b == 0xFF);
        }
        r[1] = (int)d;
        r[2] = (int)sink_flush(&s);
        d += r[2];

        /* raw suffix, verbatim (device un-stuffs MEL forward and VLC
         * backward from it); count the stuffing events so the device
         * repack can size its shift-candidate set statically */
        memcpy(digest + d, seg + suf, (size_t)scup);
        int nff = 0, n7f = 0;
        for (long long j = 0; j < scup; j++) {
            nff += (seg[suf + j] == 0xFF);
            n7f += (seg[suf + j] == 0x7F);
        }
        r[3] = (int)d;
        r[4] = (int)scup;
        r[5] = nff;
        r[6] = n7f;
        d += scup;
        r[0] = 0;
        long long mel_bits = 0, vlc_bits = 4;
        int pf = 0;
        for (long long j = suf; j < L - 2; j++) {
            mel_bits += pf ? 7 : 8;
            pf = seg[j] == 0xFF;
        }
        int prev = seg[L - 2];
        for (long long j = L - 3; j >= suf; j--) {
            vlc_bits += (prev > 0x8F && seg[j] == 0x7F) ? 7 : 8;
            prev = seg[j];
        }
        bits3[3 * (long long)i] = (int)ms_bits;
        bits3[3 * (long long)i + 1] = (int)mel_bits;
        bits3[3 * (long long)i + 2] = (int)vlc_bits;
    }
    *dused = d;
    return 0;
}
