// Zstandard (RFC 8878) frame decoder, the CRC-32C that OCDBT files end
// with, and a writer of raw-block zstd frames.  Host code, bound with
// ctypes by zstd.py; no dictionary support (a frame that names one is
// refused).  Every malformed or truncated input raises an error through
// the C interface: the decoder never returns short or wrong bytes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
    using std::runtime_error::runtime_error;
};
struct TooSmall : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void corrupt(const char* what) { throw Corrupt(what); }

inline uint32_t le32(const uint8_t* p) {
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
           uint32_t(p[3]) << 24;
}
inline uint64_t le64(const uint8_t* p) {
    return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64 and CRC-32C
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
    return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, le64(p));
            v2 = xround(v2, le64(p + 8));
            v3 = xround(v3, le64(p + 16));
            v4 = xround(v4, le64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += uint64_t(n);
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

struct Crc32cTable {
    uint32_t t[8][256];
    Crc32cTable() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (int s = 1; s < 8; ++s)
            for (uint32_t i = 0; i < 256; ++i)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};
const Crc32cTable kCrc;

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
    crc = ~crc;
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t v = le64(p) ^ crc;
        crc = kCrc.t[7][v & 0xFF] ^ kCrc.t[6][(v >> 8) & 0xFF] ^
              kCrc.t[5][(v >> 16) & 0xFF] ^ kCrc.t[4][(v >> 24) & 0xFF] ^
              kCrc.t[3][(v >> 32) & 0xFF] ^ kCrc.t[2][(v >> 40) & 0xFF] ^
              kCrc.t[1][(v >> 48) & 0xFF] ^ kCrc.t[0][v >> 56];
    }
    for (; n; --n, ++p) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p) & 0xFF];
    return ~crc;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// Forward little-endian bits (FSE table descriptions).
struct FwdBits {
    const uint8_t* p;
    size_t n;
    size_t bit = 0;
    FwdBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    uint32_t peek(int k) const {  // k <= 24; bits past the end read as 0
        uint32_t v = 0;
        size_t byte = bit >> 3;
        for (int i = 0; i < 4; ++i)
            if (byte + i < n) v |= uint32_t(p[byte + i]) << (8 * i);
        return (v >> (bit & 7)) & ((1u << k) - 1);
    }
    void skip(int k) { bit += k; }
    size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit stream (Huffman streams, FSE-coded weights and sequences):
// read from the end toward the start; the final byte's highest set bit
// marks where it begins.  ``pos`` counts the unread bits; bits before the
// start read as 0 and drive ``pos`` negative (an overflow).
struct BackBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;
    BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
        if (n == 0) corrupt("empty bit stream");
        uint8_t last = p[n - 1];
        if (last == 0) corrupt("bit stream without its end marker");
        pos = int64_t(n - 1) * 8 + highbit(last);
    }
    // the ``k`` bits ending at ``end`` (bits below 0 are 0), k <= 56
    uint64_t bits_at(int64_t end, int k) const {
        int64_t start = end - k;
        int shift = 0;
        if (start < 0) {
            shift = int(-start);
            if (shift >= k) return 0;
            k -= shift;
            start = 0;
        }
        size_t byte = size_t(start) >> 3;
        uint64_t v;
        if (byte + 8 <= n) {
            std::memcpy(&v, p + byte, 8);
        } else {
            v = 0;
            for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
        }
        v = (v >> (start & 7)) & ((uint64_t(1) << k) - 1);
        return v << shift;
    }
    uint64_t read(int k) {
        if (k == 0) return 0;
        uint64_t v = bits_at(pos, k);
        pos -= k;
        return v;
    }
    uint64_t peek(int k) const { return bits_at(pos, k); }
    void skip(int k) { pos -= k; }
    bool overflowed() const { return pos < 0; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
    uint16_t symbol;
    uint8_t nbits;
    uint16_t base;  // next state's base
};

struct FseTable {
    int log = 0;
    std::vector<FseEntry> t;
    bool ready = false;
};

// Read a table description (RFC 8878 4.1.1); returns the bytes used.
size_t read_fse_counts(const uint8_t* p, size_t n, int max_log, int max_symbol,
                       std::vector<int16_t>& norm, int& log) {
    if (n == 0) corrupt("truncated FSE table description");
    FwdBits br(p, n);
    log = int(br.peek(4)) + 5;
    br.skip(4);
    if (log > max_log) corrupt("FSE accuracy log too large");
    int remaining = (1 << log) + 1;
    int threshold = 1 << log;
    int nbits = log + 1;
    int symbol = 0;
    bool previous0 = false;
    norm.assign(max_symbol + 1, 0);
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous0) {
            int n0 = symbol;
            while (br.peek(2) == 3) {
                n0 += 3;
                br.skip(2);
                if (br.bit > n * 8) corrupt("truncated FSE table description");
            }
            n0 += int(br.peek(2));
            br.skip(2);
            if (n0 > max_symbol) corrupt("FSE table symbol out of range");
            while (symbol < n0) norm[symbol++] = 0;
            if (symbol > max_symbol) break;
        }
        int max = (2 * threshold - 1) - remaining;
        int count;
        uint32_t low = br.peek(nbits - 1);
        if (int(low & (threshold - 1)) < max) {
            count = int(low & (threshold - 1));
            br.skip(nbits - 1);
        } else {
            count = int(br.peek(nbits) & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            br.skip(nbits);
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = int16_t(count);
        previous0 = count == 0;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
        if (br.bit > n * 8) corrupt("truncated FSE table description");
    }
    if (remaining != 1 || br.bit > n * 8) corrupt("corrupt FSE table description");
    norm.resize(symbol);
    return br.bytes_used();
}

void build_fse(FseTable& tab, const int16_t* norm, int nsym, int log) {
    int size = 1 << log;
    tab.log = log;
    tab.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym > 0 ? nsym : 1);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] == -1) {
            if (high < 0) corrupt("FSE table overfull");
            tab.t[high--].symbol = uint16_t(s);
            next[s] = 1;
        } else {
            next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            tab.t[pos].symbol = uint16_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0) corrupt("FSE table does not fill its states");
    for (int u = 0; u < size; ++u) {
        uint32_t s = tab.t[u].symbol;
        uint32_t ns = next[s]++;
        if (ns == 0) corrupt("FSE state without a count");
        int nb = log - highbit(ns);
        tab.t[u].nbits = uint8_t(nb);
        tab.t[u].base = uint16_t((ns << nb) - size);
    }
    tab.ready = true;
}

void build_rle(FseTable& tab, int symbol) {
    tab.log = 0;
    tab.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    tab.ready = true;
}

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

struct HufEntry {
    uint8_t symbol;
    uint8_t nbits;
};

struct HufTable {
    int max_bits = 0;
    std::vector<HufEntry> t;
    bool ready = false;
};

// Read a Huffman tree description (RFC 8878 4.2.1); returns bytes used.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& h) {
    if (n == 0) corrupt("truncated Huffman tree description");
    uint8_t hb = p[0];
    uint8_t w[256];
    int nw = 0;
    size_t used;
    if (hb < 128) {
        // FSE-compressed weights, two interleaved states
        size_t csize = hb;
        if (csize == 0 || 1 + csize > n) corrupt("truncated Huffman weights");
        std::vector<int16_t> norm;
        int log;
        size_t th = read_fse_counts(p + 1, csize, 6, 255, norm, log);
        if (th >= csize) corrupt("Huffman weights without a bit stream");
        FseTable ft;
        build_fse(ft, norm.data(), int(norm.size()), log);
        BackBits bs(p + 1 + th, csize - th);
        uint32_t s1 = uint32_t(bs.read(log)), s2 = uint32_t(bs.read(log));
        while (true) {
            if (nw > 254) corrupt("too many Huffman weights");
            const FseEntry& e1 = ft.t[s1];
            w[nw++] = uint8_t(e1.symbol);
            s1 = e1.base + uint32_t(bs.read(e1.nbits));
            if (bs.overflowed()) {
                w[nw++] = uint8_t(ft.t[s2].symbol);
                break;
            }
            if (nw > 254) corrupt("too many Huffman weights");
            const FseEntry& e2 = ft.t[s2];
            w[nw++] = uint8_t(e2.symbol);
            s2 = e2.base + uint32_t(bs.read(e2.nbits));
            if (bs.overflowed()) {
                if (nw > 254) corrupt("too many Huffman weights");
                w[nw++] = uint8_t(ft.t[s1].symbol);
                break;
            }
        }
        used = 1 + csize;
    } else {
        nw = hb - 127;
        size_t nbytes = (size_t(nw) + 1) / 2;
        if (1 + nbytes > n) corrupt("truncated Huffman weights");
        for (int i = 0; i < nw; ++i) {
            uint8_t b = p[1 + i / 2];
            w[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
        used = 1 + nbytes;
    }
    // the last symbol's weight is implied
    uint32_t sum = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > 11) corrupt("Huffman weight too large");
        if (w[i]) sum += 1u << (w[i] - 1);
    }
    if (sum == 0) corrupt("Huffman weights all zero");
    int max_bits = highbit(sum) + 1;
    if (max_bits > 11) corrupt("Huffman code too long");
    uint32_t left = (1u << max_bits) - sum;
    if (left & (left - 1)) corrupt("Huffman weights do not complete a tree");
    if (nw >= 256) corrupt("too many Huffman symbols");
    w[nw++] = uint8_t(highbit(left) + 1);
    h.max_bits = max_bits;
    h.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
    size_t pos = 0;
    for (int wt = 1; wt <= max_bits; ++wt) {
        for (int s = 0; s < nw; ++s) {
            if (w[s] != wt) continue;
            size_t cnt = size_t(1) << (wt - 1);
            HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - wt)};
            for (size_t i = 0; i < cnt; ++i) h.t[pos + i] = e;
            pos += cnt;
        }
    }
    if (pos != h.t.size()) corrupt("Huffman table incomplete");
    h.ready = true;
    return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out,
                    size_t count) {
    BackBits bs(p, n);
    const int mb = h.max_bits;
    const HufEntry* t = h.t.data();
    for (size_t i = 0; i < count; ++i) {
        const HufEntry& e = t[bs.peek(mb)];
        out[i] = e.symbol;
        bs.skip(e.nbits);
        if (bs.overflowed()) corrupt("Huffman stream overrun");
    }
    if (bs.pos != 0) corrupt("Huffman stream not fully consumed");
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,
                              14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                              25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
                              37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
    HufTable huf;
    FseTable ll, of, ml;
    uint64_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lit;
};

size_t read_seq_table(const uint8_t* p, size_t n, int mode, FseTable& tab,
                      const int16_t* dflt, int ndflt, int dlog, int max_log,
                      int max_symbol, const char* name) {
    switch (mode) {
        case 0:
            build_fse(tab, dflt, ndflt, dlog);
            return 0;
        case 1:
            if (n < 1) corrupt("truncated RLE sequence table");
            if (p[0] > max_symbol) corrupt("RLE sequence symbol out of range");
            build_rle(tab, p[0]);
            return 1;
        case 2: {
            std::vector<int16_t> norm;
            int log;
            size_t used = read_fse_counts(p, n, max_log, max_symbol, norm, log);
            build_fse(tab, norm.data(), int(norm.size()), log);
            return used;
        }
        default:
            if (!tab.ready) corrupt(name);
            return 0;
    }
}

// Decode one compressed block into out[pos..]; returns the new pos.
size_t compressed_block(FrameState& st, const uint8_t* p, size_t n,
                        uint8_t* out, size_t frame_start, size_t pos,
                        size_t cap, size_t block_max) {
    // ---- literals section ----
    if (n < 1) corrupt("truncated literals header");
    int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t regen, csize = 0, hdr;
    const uint8_t* lits;
    if (ltype < 2) {
        if (sf == 0 || sf == 2) {
            regen = p[0] >> 3;
            hdr = 1;
        } else if (sf == 1) {
            if (n < 2) corrupt("truncated literals header");
            regen = (p[0] >> 4) + (size_t(p[1]) << 4);
            hdr = 2;
        } else {
            if (n < 3) corrupt("truncated literals header");
            regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
            hdr = 3;
        }
        if (regen > block_max) corrupt("literals larger than a block");
        if (ltype == 0) {
            if (hdr + regen > n) corrupt("truncated raw literals");
            lits = p + hdr;
            hdr += regen;
        } else {
            if (hdr + 1 > n) corrupt("truncated RLE literals");
            st.lit.assign(regen, p[hdr]);
            lits = st.lit.data();
            hdr += 1;
        }
    } else {
        int nstreams = sf == 0 ? 1 : 4;
        if (sf < 2) {
            if (n < 3) corrupt("truncated literals header");
            uint32_t h = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
            regen = (h >> 4) & 0x3FF;
            csize = (h >> 14) & 0x3FF;
            hdr = 3;
        } else if (sf == 2) {
            if (n < 4) corrupt("truncated literals header");
            uint32_t h = le32(p);
            regen = (h >> 4) & 0x3FFF;
            csize = (h >> 18) & 0x3FFF;
            hdr = 4;
        } else {
            if (n < 5) corrupt("truncated literals header");
            uint64_t h = le32(p) | uint64_t(p[4]) << 32;
            regen = (h >> 4) & 0x3FFFF;
            csize = (h >> 22) & 0x3FFFF;
            hdr = 5;
        }
        if (regen > block_max) corrupt("literals larger than a block");
        if (hdr + csize > n) corrupt("truncated compressed literals");
        const uint8_t* q = p + hdr;
        size_t qn = csize;
        if (ltype == 2) {
            size_t used = read_huffman(q, qn, st.huf);
            q += used;
            qn -= used;
        } else if (!st.huf.ready) {
            corrupt("treeless literals without an earlier Huffman table");
        }
        st.lit.resize(regen);
        if (nstreams == 1) {
            huffman_stream(st.huf, q, qn, st.lit.data(), regen);
        } else {
            if (qn < 6) corrupt("truncated Huffman jump table");
            size_t s1 = q[0] | size_t(q[1]) << 8, s2 = q[2] | size_t(q[3]) << 8,
                   s3 = q[4] | size_t(q[5]) << 8;
            if (6 + s1 + s2 + s3 > qn) corrupt("corrupt Huffman jump table");
            size_t s4 = qn - 6 - s1 - s2 - s3;
            size_t seg = (regen + 3) / 4;
            if (3 * seg > regen) corrupt("too few literals for four streams");
            const uint8_t* b = q + 6;
            huffman_stream(st.huf, b, s1, st.lit.data(), seg);
            huffman_stream(st.huf, b + s1, s2, st.lit.data() + seg, seg);
            huffman_stream(st.huf, b + s1 + s2, s3, st.lit.data() + 2 * seg, seg);
            huffman_stream(st.huf, b + s1 + s2 + s3, s4, st.lit.data() + 3 * seg,
                           regen - 3 * seg);
        }
        lits = st.lit.data();
        hdr += csize;
    }
    p += hdr;
    n -= hdr;

    // ---- sequences section ----
    size_t nseq;
    if (n < 1) corrupt("truncated sequences header");
    if (p[0] == 0) {
        nseq = 0;
        p += 1;
        n -= 1;
    } else if (p[0] < 128) {
        nseq = p[0];
        p += 1;
        n -= 1;
    } else if (p[0] < 255) {
        if (n < 2) corrupt("truncated sequences header");
        nseq = ((size_t(p[0]) - 128) << 8) + p[1];
        p += 2;
        n -= 2;
    } else {
        if (n < 3) corrupt("truncated sequences header");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        p += 3;
        n -= 3;
    }
    const uint8_t* lend = lits + regen;
    size_t out0 = pos;
    if (nseq == 0) {
        if (n != 0) corrupt("bytes after an empty sequences section");
    } else {
        if (n < 1) corrupt("truncated sequences header");
        uint8_t modes = p[0];
        if (modes & 3) corrupt("reserved sequence mode bits set");
        p += 1;
        n -= 1;
        size_t u;
        u = read_seq_table(p, n, modes >> 6, st.ll, kLLDefault, 36, 6, 9, 35,
                           "repeated literal-length table without one");
        p += u;
        n -= u;
        u = read_seq_table(p, n, (modes >> 4) & 3, st.of, kOFDefault, 29, 5, 8,
                           31, "repeated offset table without one");
        p += u;
        n -= u;
        u = read_seq_table(p, n, (modes >> 2) & 3, st.ml, kMLDefault, 53, 6, 9,
                           52, "repeated match-length table without one");
        p += u;
        n -= u;
        BackBits bs(p, n);
        uint32_t sll = uint32_t(bs.read(st.ll.log));
        uint32_t sof = uint32_t(bs.read(st.of.log));
        uint32_t sml = uint32_t(bs.read(st.ml.log));
        const FseEntry* tll = st.ll.t.data();
        const FseEntry* tof = st.of.t.data();
        const FseEntry* tml = st.ml.t.data();
        uint64_t* rep = st.rep;
        for (size_t i = 0; i < nseq; ++i) {
            const FseEntry &ell = tll[sll], &eof = tof[sof], &eml = tml[sml];
            uint32_t ofc = eof.symbol, llc = ell.symbol, mlc = eml.symbol;
            if (ofc > 31) corrupt("offset code out of range");
            uint64_t ofv = (uint64_t(1) << ofc) + bs.read(int(ofc));
            uint64_t ml = kMLBase[mlc] + bs.read(kMLBits[mlc]);
            uint64_t ll = kLLBase[llc] + bs.read(kLLBits[llc]);
            uint64_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
                if (idx == 0) {
                    offset = rep[0];
                } else {
                    offset = idx == 3 ? rep[0] - 1 : rep[idx];
                    if (offset == 0) corrupt("zero repeat offset");
                    if (idx != 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                }
            }
            if (i + 1 < nseq) {
                sll = ell.base + uint32_t(bs.read(ell.nbits));
                sml = eml.base + uint32_t(bs.read(eml.nbits));
                sof = eof.base + uint32_t(bs.read(eof.nbits));
            }
            if (bs.overflowed()) corrupt("sequence bit stream overrun");
            // execute
            if (ll > size_t(lend - lits)) corrupt("sequence reads past the literals");
            if (pos + ll + ml - out0 > block_max) corrupt("block larger than its limit");
            if (pos + ll + ml > cap) throw TooSmall("output buffer too small");
            std::memcpy(out + pos, lits, ll);
            lits += ll;
            pos += ll;
            if (offset > pos - frame_start) corrupt("match offset before the frame");
            uint8_t* d = out + pos;
            const uint8_t* s = d - offset;
            if (offset >= ml) {
                std::memcpy(d, s, ml);
            } else {
                for (uint64_t k = 0; k < ml; ++k) d[k] = s[k];
            }
            pos += ml;
        }
        if (bs.pos != 0) corrupt("sequence bit stream not fully consumed");
    }
    size_t rest = size_t(lend - lits);
    if (pos + rest - out0 > block_max) corrupt("block larger than its limit");
    if (pos + rest > cap) throw TooSmall("output buffer too small");
    std::memcpy(out + pos, lits, rest);
    return pos + rest;
}

// Decode one frame at src[*off]; returns the bytes written at out[pos..].
size_t decode_frame(const uint8_t* src, size_t n, size_t& off, uint8_t* out,
                    size_t pos, size_t cap, FrameState& st) {
    const uint8_t* p = src + off;
    size_t left = n - off;
    if (left < 6) corrupt("truncated frame header");
    uint8_t fhd = p[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) corrupt("reserved frame header bit set");
    size_t h = 5;
    uint64_t window = 0;
    if (!single) {
        uint8_t wd = p[h++];
        int exp = wd >> 3, mant = wd & 7;
        uint64_t base = uint64_t(1) << (10 + exp);
        window = base + (base / 8) * mant;
    }
    static const int did_sizes[4] = {0, 1, 2, 4};
    int ds = did_sizes[did_flag];
    int fs = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (left < h + ds + fs) corrupt("truncated frame header");
    uint64_t dict_id = 0;
    for (int i = 0; i < ds; ++i) dict_id |= uint64_t(p[h + i]) << (8 * i);
    h += ds;
    if (dict_id != 0) throw Corrupt("frame needs a dictionary, which is not supported");
    bool has_fcs = fs > 0;
    uint64_t fcs = 0;
    for (int i = 0; i < fs; ++i) fcs |= uint64_t(p[h + i]) << (8 * i);
    if (fs == 2) fcs += 256;
    h += fs;
    if (single) window = fcs;
    size_t block_max = size_t(window < (128u << 10) ? window : (128u << 10));
    if (has_fcs && fcs > cap - pos) throw TooSmall("output buffer too small");
    st.huf.ready = st.ll.ready = st.of.ready = st.ml.ready = false;
    st.rep[0] = 1;
    st.rep[1] = 4;
    st.rep[2] = 8;
    size_t start = pos;
    size_t q = h;
    while (true) {
        if (left < q + 3) corrupt("truncated block header");
        uint32_t bh = p[q] | uint32_t(p[q + 1]) << 8 | uint32_t(p[q + 2]) << 16;
        q += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t bsize = bh >> 3;
        if (type == 3) corrupt("reserved block type");
        size_t in_size = type == 1 ? 1 : bsize;
        if (left < q + in_size) corrupt("truncated block");
        if (type == 0) {
            if (bsize > block_max) corrupt("raw block larger than its limit");
            if (bsize > cap - pos) throw TooSmall("output buffer too small");
            std::memcpy(out + pos, p + q, bsize);
            pos += bsize;
        } else if (type == 1) {
            if (bsize > block_max) corrupt("RLE block larger than its limit");
            if (bsize > cap - pos) throw TooSmall("output buffer too small");
            std::memset(out + pos, p[q], bsize);
            pos += bsize;
        } else {
            if (bsize > block_max) corrupt("compressed block larger than its limit");
            pos = compressed_block(st, p + q, bsize, out, start, pos, cap, block_max);
        }
        q += in_size;
        if (last) break;
    }
    if (has_fcs && pos - start != fcs) corrupt("frame content size does not match");
    if (checksum) {
        if (left < q + 4) corrupt("truncated content checksum");
        uint32_t want = le32(p + q);
        uint32_t got = uint32_t(xxh64(out + start, pos - start, 0));
        if (want != got) corrupt("content checksum mismatch");
        q += 4;
    }
    off += q;
    return pos - start;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

size_t decompress(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
    FrameState st;
    size_t off = 0, pos = 0;
    if (n == 0) corrupt("empty input");
    while (off < n) {
        if (n - off < 4) corrupt("truncated frame magic");
        uint32_t magic = le32(src + off);
        if (skippable(magic)) {
            if (n - off < 8) corrupt("truncated skippable frame");
            uint64_t sz = le32(src + off + 4);
            if (n - off - 8 < sz) corrupt("truncated skippable frame");
            off += 8 + sz;
            continue;
        }
        if (magic != kMagic) corrupt("not a zstd frame (bad magic number)");
        pos += decode_frame(src, n, off, out, pos, cap, st);
    }
    return pos;
}

// Sum of the frames' content sizes, or -1 where a frame does not state it.
int64_t content_size(const uint8_t* src, size_t n) {
    size_t off = 0;
    uint64_t total = 0;
    if (n == 0) corrupt("empty input");
    while (off < n) {
        if (n - off < 4) corrupt("truncated frame magic");
        uint32_t magic = le32(src + off);
        if (skippable(magic)) {
            if (n - off < 8) corrupt("truncated skippable frame");
            uint64_t sz = le32(src + off + 4);
            if (n - off - 8 < sz) corrupt("truncated skippable frame");
            off += 8 + sz;
            continue;
        }
        if (magic != kMagic) corrupt("not a zstd frame (bad magic number)");
        const uint8_t* p = src + off;
        size_t left = n - off;
        if (left < 6) corrupt("truncated frame header");
        uint8_t fhd = p[4];
        int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
        static const int did_sizes[4] = {0, 1, 2, 4};
        int fs = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
        if (fs == 0) return -1;
        size_t h = 5 + (single ? 0 : 1) + did_sizes[fhd & 3];
        if (left < h + fs) corrupt("truncated frame header");
        uint64_t fcs = 0;
        for (int i = 0; i < fs; ++i) fcs |= uint64_t(p[h + i]) << (8 * i);
        if (fs == 2) fcs += 256;
        total += fcs;
        // walk the blocks to find the next frame
        size_t q = h + fs;
        while (true) {
            if (left < q + 3) corrupt("truncated block header");
            uint32_t bh = p[q] | uint32_t(p[q + 1]) << 8 | uint32_t(p[q + 2]) << 16;
            q += 3;
            size_t in_size = ((bh >> 1) & 3) == 1 ? 1 : (bh >> 3);
            if (left < q + in_size) corrupt("truncated block");
            q += in_size;
            if (bh & 1) break;
        }
        if (checksum) q += 4;
        if (left < q) corrupt("truncated content checksum");
        off += q;
    }
    return int64_t(total);
}

void set_err(char* err, size_t errlen, const char* msg) {
    if (err && errlen) {
        std::snprintf(err, errlen, "%s", msg);
    }
}

}  // namespace

extern "C" {

// Decode every frame of src into dst.  Returns the bytes written, -1 on
// malformed input and -2 when dst is too small (message in err).
int64_t m3z_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                       char* err, size_t errlen) {
    try {
        return int64_t(decompress(src, n, dst, cap));
    } catch (const TooSmall& e) {
        set_err(err, errlen, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// The decoded size the frames state, -1 when a frame omits it, -2 on
// malformed input.
int64_t m3z_content_size(const uint8_t* src, size_t n, char* err, size_t errlen) {
    try {
        return content_size(src, n);
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -2;
    }
}

// Bytes a raw-block frame of n bytes takes.
int64_t m3z_raw_frame_size(size_t n) {
    size_t blocks = n == 0 ? 1 : (n + (128u << 10) - 1) / (128u << 10);
    return int64_t(4 + 1 + 1 + 8 + 3 * blocks + n);
}

// Write src as one zstd frame of raw blocks (at most 128 KiB each, a
// 128 KiB window, the content size stated, no checksum).  Returns the
// frame's size; dst must hold m3z_raw_frame_size(n) bytes.
int64_t m3z_raw_frame(const uint8_t* src, size_t n, uint8_t* dst) {
    const size_t B = 128u << 10;
    uint8_t* o = dst;
    uint32_t magic = kMagic;
    std::memcpy(o, &magic, 4);
    o[4] = 0xC0;         // 8-byte content size, not single-segment
    o[5] = (17 - 10) << 3;  // window 2^17
    uint64_t fcs = n;
    for (int i = 0; i < 8; ++i) o[6 + i] = uint8_t(fcs >> (8 * i));
    o += 14;
    size_t done = 0;
    do {
        size_t k = n - done < B ? n - done : B;
        uint32_t bh = uint32_t(k) << 3 | (done + k == n ? 1u : 0u);
        o[0] = uint8_t(bh);
        o[1] = uint8_t(bh >> 8);
        o[2] = uint8_t(bh >> 16);
        std::memcpy(o + 3, src + done, k);
        o += 3 + k;
        done += k;
    } while (done < n);
    return int64_t(o - dst);
}

uint32_t m3z_crc32c(const uint8_t* src, size_t n, uint32_t crc) {
    return crc32c(src, n, crc);
}

}  // extern "C"
