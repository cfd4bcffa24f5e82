// OpenEXR decoder for the port's RTMV preparation: host C++17, a plain C
// interface bound with ctypes (datasets/exr.py), no library beyond the C++
// standard library (the inflate below stands in for zlib).
//
// It follows OpenEXR's published "OpenEXR File Layout" document (magic and
// version field, the header's attributes, the scanline offset table, the
// chunks) and the codec steps of the OpenEXR library's sources:
//   * ImfRle.cpp / ImfRleCompressor.cpp: the byte runs (a signed count:
//     n >= 0 repeats the next byte n + 1 times, n < 0 copies -n bytes);
//   * ImfZip.cpp: the byte predictor (each byte minus its predecessor plus
//     128) and the interleave of the even and the odd bytes, under zlib
//     (RFC 1950) deflate (RFC 1951);
//   * ImfPizCompressor.cpp: the bitmap of the 16-bit values in use and its
//     reverse lookup table, Huffman coding (ImfHuf.cpp: canonical codes of up
//     to 58 bits, the 6-bit code-length table with its zero runs, a run code
//     that repeats the previous value up to 255 times, 14-bit lookup) and the
//     2D Haar wavelet per channel (ImfWav.cpp: 14-bit and 16-bit lifting);
//   * half to float as Imath converts it: exact, NaN payloads kept.
//
// It reads single-part scanline files (version 2; the long-name bit is
// accepted) compressed with NONE, RLE, ZIPS, ZIP or PIZ, whose channels are
// HALF or FLOAT, and returns R, G, B and, where the file has it, A as
// float32. A chunk whose size equals its raw size is stored raw, as the
// library writes it. It refuses PXR24, B44, B44A, DWAA and DWAB, UINT and
// subsampled channels, tiled, deep and multi-part files, a data window that
// differs from the display window and a file without R, G and B: it says
// why and returns no image.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ExrError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw ExrError{what}; }

const char* const kCompressionNames[] = {"NONE", "RLE",  "ZIPS", "ZIP",
                                         "PIZ",  "PXR24", "B44", "B44A",
                                         "DWAA", "DWAB"};
constexpr int kNone = 0, kRle = 1, kZips = 2, kZip = 3, kPiz = 4;
constexpr int kUint = 0, kHalf = 1, kFloat = 2;

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// ------------------------------------------------------------- header

struct Channel {
  std::string name;
  int type = 0;
  int xs = 1, ys = 1;
  int bytes() const { return type == kHalf ? 2 : 4; }
};

struct Box {
  int xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  bool operator!=(const Box& o) const {
    return xmin != o.xmin || ymin != o.ymin || xmax != o.xmax ||
           ymax != o.ymax;
  }
  std::string str() const {
    return "(" + std::to_string(xmin) + ", " + std::to_string(ymin) + ") - (" +
           std::to_string(xmax) + ", " + std::to_string(ymax) + ")";
  }
};

struct Header {
  std::vector<Channel> channels;
  int compression = -1;
  Box data, display;
  bool have_data = false, have_display = false;
  int line_order = -1;
  size_t end = 0;           // the offset table's position
  int width = 0, height = 0;
  int rgba[4] = {-1, -1, -1, -1};   // channel index of R, G, B, A
  int out_channels() const { return rgba[3] >= 0 ? 4 : 3; }
  int lines_per_chunk() const {
    return compression == kZip ? 16 : compression == kPiz ? 32 : 1;
  }
  size_t line_bytes() const {
    size_t n = 0;
    for (const Channel& c : channels) n += size_t(c.bytes()) * width;
    return n;
  }
};

struct Cursor {
  const uint8_t* p;
  size_t n, pos;
  void need(size_t k) const {
    if (k > n - pos) fail("the file ends inside its header");
  }
  std::string cstr(const char* what) {
    const void* z = std::memchr(p + pos, 0, n - pos);
    if (!z) fail(std::string("the file ends inside ") + what);
    std::string s(reinterpret_cast<const char*>(p + pos),
                  static_cast<const uint8_t*>(z) - (p + pos));
    pos += s.size() + 1;
    return s;
  }
};

Box read_box(const uint8_t* v) {
  return Box{int32_t(le32(v)), int32_t(le32(v + 4)), int32_t(le32(v + 8)),
             int32_t(le32(v + 12))};
}

void parse_channels(const uint8_t* v, size_t size, Header* h) {
  Cursor c{v, size, 0};
  while (true) {
    std::string name = c.cstr("the channel list");
    if (name.empty()) break;
    if (size - c.pos < 16) fail("the channel list is cut short");
    Channel ch;
    ch.name = name;
    ch.type = int32_t(le32(v + c.pos));
    ch.xs = int32_t(le32(v + c.pos + 8));
    ch.ys = int32_t(le32(v + c.pos + 12));
    c.pos += 16;
    h->channels.push_back(ch);
  }
}

Header parse_header(const uint8_t* data, size_t n) {
  if (n < 8 || le32(data) != 20000630u)
    fail("not an OpenEXR file (no magic number 76 2f 31 01)");
  uint32_t version = le32(data + 4);
  if ((version & 0xff) != 2)
    fail("OpenEXR version " + std::to_string(version & 0xff) +
         " is not supported (version 2 is)");
  if (version & 0x200) fail("tiled files are not supported");
  if (version & 0x800) fail("deep (non-image) files are not supported");
  if (version & 0x1000) fail("multi-part files are not supported");
  if (version & ~uint32_t(0x4ff))
    fail("unknown version flags " + std::to_string(version >> 8));
  Header h;
  Cursor c{data, n, 8};
  bool have_channels = false;
  while (true) {
    std::string name = c.cstr("the header");
    if (name.empty()) break;
    std::string type = c.cstr("the header");
    c.need(4);
    int32_t size = int32_t(le32(data + c.pos));
    c.pos += 4;
    if (size < 0) fail("attribute " + name + " has a negative size");
    c.need(size_t(size));
    const uint8_t* v = data + c.pos;
    c.pos += size_t(size);
    auto expect = [&](const char* t, int32_t s) {
      if (type != t || size < s)
        fail("attribute " + name + " is a " + type + " of " +
             std::to_string(size) + " bytes");
    };
    if (name == "channels") {
      expect("chlist", 1);
      parse_channels(v, size_t(size), &h);
      have_channels = true;
    } else if (name == "compression") {
      expect("compression", 1);
      h.compression = v[0];
    } else if (name == "dataWindow") {
      expect("box2i", 16);
      h.data = read_box(v);
      h.have_data = true;
    } else if (name == "displayWindow") {
      expect("box2i", 16);
      h.display = read_box(v);
      h.have_display = true;
    } else if (name == "lineOrder") {
      expect("lineOrder", 1);
      h.line_order = v[0];
    } else if (name == "type") {
      std::string t(reinterpret_cast<const char*>(v), size_t(size));
      t = t.substr(0, t.find('\0'));
      if (t != "scanlineimage")
        fail("part type " + t + " is not supported (scanlineimage is)");
    }
  }
  h.end = c.pos;
  if (!have_channels || h.compression < 0 || !h.have_data ||
      !h.have_display || h.line_order < 0)
    fail("the header lacks one of channels, compression, dataWindow, "
         "displayWindow and lineOrder");
  if (h.compression > kPiz) {
    if (h.compression < 10)
      fail(std::string(kCompressionNames[h.compression]) +
           " compression is not supported (NONE, RLE, ZIPS, ZIP and PIZ are)");
    fail("unknown compression " + std::to_string(h.compression));
  }
  if (h.line_order > 2)
    fail("unknown line order " + std::to_string(h.line_order));
  if (h.data != h.display)
    fail("the data window " + h.data.str() +
         " differs from the display window " + h.display.str());
  if (h.data.xmax < h.data.xmin || h.data.ymax < h.data.ymin)
    fail("an empty data window " + h.data.str());
  int64_t w = int64_t(h.data.xmax) - h.data.xmin + 1;
  int64_t ht = int64_t(h.data.ymax) - h.data.ymin + 1;
  if (w > (1 << 24) || ht > (1 << 24) || w * ht > (int64_t(1) << 28))
    fail("a data window of " + std::to_string(w) + " x " + std::to_string(ht) +
         " pixels is too large");
  h.width = int(w);
  h.height = int(ht);
  std::string names;
  for (size_t i = 0; i < h.channels.size(); ++i) {
    const Channel& ch = h.channels[i];
    if (ch.type == kUint)
      fail("UINT channel " + ch.name + " is not supported (HALF and FLOAT are)");
    if (ch.type != kHalf && ch.type != kFloat)
      fail("channel " + ch.name + " has unknown pixel type " +
           std::to_string(ch.type));
    if (ch.xs != 1 || ch.ys != 1)
      fail("subsampled channel " + ch.name + " (x " + std::to_string(ch.xs) +
           ", y " + std::to_string(ch.ys) + ") is not supported");
    if (i && ch.name <= h.channels[i - 1].name)
      fail("the channel list is not sorted by name");
    const char* const rgba[] = {"R", "G", "B", "A"};
    for (int k = 0; k < 4; ++k)
      if (ch.name == rgba[k]) h.rgba[k] = int(i);
    names += (names.empty() ? "" : " ") + ch.name;
  }
  if (h.rgba[0] < 0 || h.rgba[1] < 0 || h.rgba[2] < 0)
    fail("no R, G and B channels (the file has: " +
         (names.empty() ? std::string("none") : names) + ")");
  return h;
}

// ------------------------------------------------------------- inflate

// RFC 1951 Huffman table: indexed by the next `bits` input bits (deflate
// packs codes from their first bit at the byte's lowest bit), each entry
// (symbol << 4) | length, 0 for no code.
struct Inflate {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  uint8_t* out;
  size_t cap, len = 0;

  void need(int k) {
    while (cnt < k) {
      // past the end the bits read are zero; read_bits checks the total
      buf |= uint64_t(pos < n ? p[pos] : 0) << cnt;
      ++pos;
      cnt += 8;
    }
  }
  uint32_t bits(int k) {
    need(k);
    uint32_t v = uint32_t(buf & ((uint64_t(1) << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
  void check_end() const {
    if (pos > n && (pos - n) * 8 > size_t(cnt))
      fail("the deflate stream ends early");
  }

  struct Table {
    std::vector<uint16_t> e;
    int bits = 0;
  };

  static Table build(const uint8_t* lens, int nsym) {
    int count[16] = {0};
    for (int i = 0; i < nsym; ++i) ++count[lens[i]];
    count[0] = 0;
    int left = 1, maxlen = 0;
    for (int l = 1; l <= 15; ++l) {
      left = left * 2 - count[l];
      if (left < 0) fail("an over-subscribed deflate code");
      if (count[l]) maxlen = l;
    }
    Table t;
    t.bits = std::max(maxlen, 1);
    t.e.assign(size_t(1) << t.bits, 0);
    int next[16] = {0};
    for (int l = 1, code = 0; l <= 15; ++l) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
    }
    for (int s = 0; s < nsym; ++s) {
      int l = lens[s];
      if (!l) continue;
      int code = next[l]++, rev = 0;
      for (int i = 0; i < l; ++i) rev |= ((code >> i) & 1) << (l - 1 - i);
      for (int r = rev; r < (1 << t.bits); r += 1 << l)
        t.e[size_t(r)] = uint16_t(s << 4 | l);
    }
    return t;
  }

  int decode(const Table& t) {
    need(t.bits);
    uint16_t e = t.e[buf & ((uint64_t(1) << t.bits) - 1)];
    if (!e) fail("an invalid deflate code");
    buf >>= e & 15;
    cnt -= e & 15;
    return e >> 4;
  }

  void put(uint8_t b) {
    if (len == cap) fail("the deflate stream holds more than the chunk");
    out[len++] = b;
  }

  void codes(const Table& lit, const Table& dist) {
    static const uint16_t kLenBase[29] = {
        3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
        31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t kDistBase[30] = {
        1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
        33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
        1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                           4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                           9, 9, 10, 10, 11, 11, 12, 12, 13,
                                           13};
    while (true) {
      int s = decode(lit);
      if (s < 256) {
        put(uint8_t(s));
        continue;
      }
      if (s == 256) return;
      s -= 257;
      if (s >= 29) fail("an invalid deflate length code");
      size_t length = kLenBase[s] + bits(kLenExtra[s]);
      int d = decode(dist);
      if (d >= 30) fail("an invalid deflate distance code");
      size_t back = kDistBase[d] + bits(kDistExtra[d]);
      if (back > len) fail("a deflate distance before the chunk's start");
      if (length > cap - len)
        fail("the deflate stream holds more than the chunk");
      uint8_t* o = out + len;
      const uint8_t* from = o - back;
      for (size_t i = 0; i < length; ++i) o[i] = from[i];
      len += length;
    }
  }

  void stored() {
    buf >>= cnt & 7;   // to the byte boundary
    cnt -= cnt & 7;
    uint32_t l = bits(16), nl = bits(16);
    if (l != (~nl & 0xffff)) fail("a stored deflate block's length check");
    // the bytes still in the bit buffer come first
    for (; l && cnt >= 8; --l) put(uint8_t(bits(8)));
    if (l > n - std::min(pos, n)) fail("the deflate stream ends early");
    if (l > cap - len) fail("the deflate stream holds more than the chunk");
    std::memcpy(out + len, p + pos, l);
    len += l;
    pos += l;
  }

  void dynamic(Table* lit, Table* dist) {
    static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};
    int nlit = int(bits(5)) + 257, ndist = int(bits(5)) + 1;
    int nclen = int(bits(4)) + 4;
    if (nlit > 286 || ndist > 30) fail("a deflate block with too many codes");
    uint8_t clen[19] = {0};
    for (int i = 0; i < nclen; ++i) clen[kOrder[i]] = uint8_t(bits(3));
    Table ct = build(clen, 19);
    uint8_t lens[286 + 30] = {0};
    for (int i = 0; i < nlit + ndist;) {
      int s = decode(ct);
      if (s < 16) {
        lens[i++] = uint8_t(s);
        continue;
      }
      int rep;
      uint8_t v = 0;
      if (s == 16) {
        if (!i) fail("a deflate length repeat with nothing before it");
        v = lens[i - 1];
        rep = 3 + int(bits(2));
      } else if (s == 17) {
        rep = 3 + int(bits(3));
      } else {
        rep = 11 + int(bits(7));
      }
      if (i + rep > nlit + ndist) fail("deflate code lengths overrun");
      while (rep--) lens[i++] = v;
    }
    if (!lens[256]) fail("a deflate block without an end code");
    *lit = build(lens, nlit);
    *dist = build(lens + nlit, ndist);
  }

  void run() {
    Table fixed_lit, fixed_dist;
    bool last = false;
    while (!last) {
      last = bits(1);
      uint32_t type = bits(2);
      if (type == 0) {
        stored();
      } else if (type == 1) {
        if (fixed_lit.e.empty()) {
          uint8_t lens[288];
          for (int i = 0; i < 288; ++i)
            lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
          fixed_lit = build(lens, 288);
          uint8_t dl[30];
          std::fill(dl, dl + 30, uint8_t(5));
          fixed_dist = build(dl, 30);
        }
        codes(fixed_lit, fixed_dist);
      } else if (type == 2) {
        Table lit, dist;
        dynamic(&lit, &dist);
        codes(lit, dist);
      } else {
        fail("a deflate block of the reserved type 3");
      }
      check_end();
    }
    // back to the byte boundary, then to the first byte not yet used
    pos -= size_t(cnt / 8);
  }
};

// zlib (RFC 1950) stream src[0:n] -> exactly cap bytes at out.
void zlib_uncompress(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  if (n < 6) fail("a ZIP chunk too short for a zlib stream");
  if ((src[0] & 15) != 8 || (src[0] >> 4) > 7 ||
      ((unsigned(src[0]) << 8) | src[1]) % 31)
    fail("a ZIP chunk without a zlib header");
  if (src[1] & 0x20) fail("a zlib stream with a preset dictionary");
  Inflate z{src + 2, n - 6, 0, 0, 0, out, cap, 0};
  z.run();
  if (z.len != cap)
    fail("a ZIP chunk inflates to " + std::to_string(z.len) + " bytes, not " +
         std::to_string(cap));
  // Adler-32, reduced every 5552 bytes (the most before b can overflow)
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < cap;) {
    size_t end = std::min(cap, i + 5552);
    for (; i < end; ++i) {
      a += out[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  const uint8_t* t = src + n - 4;
  uint32_t want = uint32_t(t[0]) << 24 | uint32_t(t[1]) << 16 |
                  uint32_t(t[2]) << 8 | t[3];
  if ((b << 16 | a) != want) fail("a ZIP chunk fails its Adler-32 check");
}

// ------------------------------------------------------------- RLE, ZIP

void rle_uncompress(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  size_t i = 0, len = 0;
  while (i < n) {
    int c = int8_t(src[i++]);
    if (c < 0) {
      size_t k = size_t(-c);
      if (k > n - i || k > cap - len) fail("an RLE run overruns its chunk");
      std::memcpy(out + len, src + i, k);
      i += k;
      len += k;
    } else {
      size_t k = size_t(c) + 1;
      if (i >= n || k > cap - len) fail("an RLE run overruns its chunk");
      std::memset(out + len, src[i++], k);
      len += k;
    }
  }
  if (len != cap)
    fail("an RLE chunk holds " + std::to_string(len) + " bytes, not " +
         std::to_string(cap));
}

// ImfZip / ImfRleCompressor: undo the predictor, then the interleave of
// the first half (even bytes) and the second half (odd bytes).
void unpredict(uint8_t* t, size_t n, uint8_t* out) {
  for (size_t i = 1; i < n; ++i) t[i] = uint8_t(t[i - 1] + t[i] - 128);
  const uint8_t *t1 = t, *t2 = t + (n + 1) / 2;
  for (size_t i = 0; i < n; ++i) out[i] = (i & 1) ? *t2++ : *t1++;
}

// ------------------------------------------------------------- PIZ

constexpr int kUShortRange = 1 << 16;
constexpr int kBitmapSize = kUShortRange >> 3;
constexpr int kHufEncSize = (1 << 16) + 1;
constexpr int kHufDecBits = 14;
constexpr int kHufDecSize = 1 << kHufDecBits;
constexpr int kShortZeroRun = 59, kLongZeroRun = 63;
constexpr int kShortestLongRun = 2 + kLongZeroRun - kShortZeroRun;

struct HufBits {   // most significant bit first (ImfHuf getBits)
  const uint8_t *p, *end;
  uint64_t c = 0;
  int lc = 0;
  uint64_t get(int k) {
    while (lc < k) {
      if (p >= end) fail("the Huffman table runs past its chunk");
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= k;
    return (c >> lc) & ((uint64_t(1) << k) - 1);
  }
};

// hufCanonicalCodeTable: lengths in hcode -> length | code << 6; longer
// codes take the numerically lower values.
void canonical_codes(std::vector<uint64_t>& hcode) {
  uint64_t n[59] = {0};
  for (uint64_t l : hcode) n[l] += 1;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (uint64_t& h : hcode)
    if (h > 0) h = h | (n[h]++ << 6);
}

struct HufDec {
  int len = 0;          // short code's length, 0 for none or long codes
  int lit = 0;          // short code's symbol
  std::vector<int> longs;   // symbols of the longer codes with this prefix
};

void huf_uncompress(const uint8_t* src, size_t n, uint16_t* out, size_t nraw) {
  if (n == 0) {
    if (nraw) fail("an empty Huffman block for " + std::to_string(nraw) +
                   " values");
    return;
  }
  if (n < 20) fail("a Huffman block too short for its header");
  uint32_t im = le32(src), iM = le32(src + 4), nbits = le32(src + 12);
  if (im >= uint32_t(kHufEncSize) || iM >= uint32_t(kHufEncSize) || im > iM)
    fail("a Huffman table of symbols " + std::to_string(im) + " to " +
         std::to_string(iM));
  std::vector<uint64_t> hcode(kHufEncSize, 0);
  HufBits tb{src + 20, src + n};
  for (uint32_t i = im; i <= iM; ++i) {
    uint64_t l = hcode[i] = tb.get(6);
    if (l == uint64_t(kLongZeroRun)) {
      uint32_t run = uint32_t(tb.get(8)) + kShortestLongRun;
      if (i + run > iM + 1) fail("a Huffman table's zero run overruns it");
      for (uint32_t k = 0; k < run; ++k) hcode[i + k] = 0;
      i += run - 1;
    } else if (l >= uint64_t(kShortZeroRun)) {
      uint32_t run = uint32_t(l) - kShortZeroRun + 2;
      if (i + run > iM + 1) fail("a Huffman table's zero run overruns it");
      for (uint32_t k = 0; k < run; ++k) hcode[i + k] = 0;
      i += run - 1;
    }
  }
  canonical_codes(hcode);
  const uint8_t* data = tb.p;
  if (uint64_t(nbits) > 8 * uint64_t(src + n - data))
    fail("a Huffman block's bit count exceeds its bytes");

  // hufBuildDecTable
  std::vector<HufDec> dec(kHufDecSize);
  for (uint32_t i = im; i <= iM; ++i) {
    uint64_t code = hcode[i] >> 6;
    int l = int(hcode[i] & 63);
    if (code >> l) fail("an invalid Huffman table entry");
    if (l > kHufDecBits) {
      HufDec& e = dec[code >> (l - kHufDecBits)];
      if (e.len) fail("an invalid Huffman table entry");
      e.longs.push_back(int(i));
    } else if (l) {
      size_t first = size_t(code) << (kHufDecBits - l);
      for (size_t k = 0; k < (size_t(1) << (kHufDecBits - l)); ++k) {
        HufDec& e = dec[first + k];
        if (e.len || !e.longs.empty())
          fail("an invalid Huffman table entry");
        e.len = l;
        e.lit = int(i);
      }
    }
  }

  // hufDecode; iM is the run-length code
  const int rlc = int(iM);
  uint16_t *o = out, *oe = out + nraw;
  const uint8_t* ie = data + (uint64_t(nbits) + 7) / 8;
  auto emit = [&](int sym, __uint128_t& c, int& lc, const uint8_t*& in) {
    if (sym == rlc) {
      if (lc < 8) {
        if (in >= ie) fail("the Huffman data ends inside a run");
        c = (c << 8) | *in++;
        lc += 8;
      }
      lc -= 8;
      int cs = int(uint8_t(c >> lc));
      if (oe - o < cs) fail("the Huffman data holds more values than its chunk");
      if (o == out) fail("a Huffman run with no value before it");
      uint16_t s = o[-1];
      while (cs-- > 0) *o++ = s;
    } else {
      if (o >= oe) fail("the Huffman data holds more values than its chunk");
      *o++ = uint16_t(sym);
    }
  };
  __uint128_t c = 0;
  int lc = 0;
  const uint8_t* in = data;
  constexpr int kMask = kHufDecSize - 1;
  while (in < ie) {
    c = (c << 8) | *in++;
    lc += 8;
    while (lc >= kHufDecBits) {
      const HufDec& e = dec[size_t(c >> (lc - kHufDecBits)) & kMask];
      if (e.len) {
        lc -= e.len;
        emit(e.lit, c, lc, in);
        continue;
      }
      if (e.longs.empty()) fail("an invalid Huffman code");
      bool found = false;
      for (int sym : e.longs) {
        int l = int(hcode[size_t(sym)] & 63);
        while (lc < l && in < ie) {
          c = (c << 8) | *in++;
          lc += 8;
        }
        if (lc >= l && (hcode[size_t(sym)] >> 6) ==
                           (uint64_t(c >> (lc - l)) &
                            ((uint64_t(1) << l) - 1))) {
          lc -= l;
          emit(sym, c, lc, in);
          found = true;
          break;
        }
      }
      if (!found) fail("an invalid Huffman code");
    }
  }
  int pad = (8 - int(nbits)) & 7;
  c >>= pad;
  lc -= pad;
  while (lc > 0) {
    const HufDec& e = dec[size_t(c << (kHufDecBits - lc)) & kMask];
    if (!e.len || e.len > lc) fail("an invalid Huffman code");
    lc -= e.len;
    emit(e.lit, c, lc, in);
  }
  if (o != oe)
    fail("the Huffman data holds " + std::to_string(o - out) +
         " values, not " + std::to_string(nraw));
}

// ImfWav: the inverse 14-bit and 16-bit lifting steps
inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = int16_t(l), hs = int16_t(h);
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  a = uint16_t(int16_t(ai));
  b = uint16_t(int16_t(ai - hi));
}

constexpr int kAOffset = 1 << 15, kModMask = (1 << 16) - 1;

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & kModMask;
  int aa = (d + bb - kAOffset) & kModMask;
  b = uint16_t(bb);
  a = uint16_t(aa);
}

inline void wdec(bool w14, uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  if (w14)
    wdec14(l, h, a, b);
  else
    wdec16(l, h, a, b);
}

// wav2Decode: nx x ny values at `in`, ox apart in x and oy in y
void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = std::min(nx, ny);
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + std::ptrdiff_t(oy) * (ny - p2);
    std::ptrdiff_t oy1 = std::ptrdiff_t(oy) * p, oy2 = std::ptrdiff_t(oy) * p2;
    std::ptrdiff_t ox1 = std::ptrdiff_t(ox) * p, ox2 = std::ptrdiff_t(ox) * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + std::ptrdiff_t(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        wdec(w14, *px, *p10, i00, i10);
        wdec(w14, *p01, *p11, i01, i11);
        wdec(w14, i00, i01, *px, *p01);
        wdec(w14, i10, i11, *p10, *p11);
      }
      if (nx & p) {   // the odd column
        uint16_t* p10 = px + oy1;
        wdec(w14, *px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {     // the odd line
      uint16_t* px = py;
      uint16_t* ex = py + std::ptrdiff_t(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        wdec(w14, *px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// PizCompressor::uncompress: src[0:n] -> nl lines of the native layout
void piz_uncompress(const uint8_t* src, size_t n, const Header& h, int nl,
                    uint8_t* out) {
  const int w = h.width;
  std::vector<size_t> start;
  size_t total = 0;
  for (const Channel& ch : h.channels) {
    start.push_back(total);
    total += size_t(w) * nl * (ch.bytes() / 2);
  }
  std::vector<uint16_t> tmp(total);
  if (n < 4) fail("a PIZ chunk too short for its bitmap range");
  uint32_t lo = uint32_t(src[0]) | uint32_t(src[1]) << 8;
  uint32_t hi = uint32_t(src[2]) | uint32_t(src[3]) << 8;
  if (hi >= uint32_t(kBitmapSize)) fail("a PIZ bitmap range past its end");
  std::vector<uint8_t> bitmap(kBitmapSize, 0);
  size_t pos = 4;
  if (lo <= hi) {
    if (hi - lo + 1 > n - pos) fail("a PIZ chunk ends inside its bitmap");
    std::memcpy(&bitmap[lo], src + pos, hi - lo + 1);
    pos += hi - lo + 1;
  }
  // reverseLutFromBitmap
  std::vector<uint16_t> lut(kUShortRange, 0);
  int k = 0;
  for (int i = 0; i < kUShortRange; ++i)
    if (i == 0 || (bitmap[size_t(i) >> 3] & (1 << (i & 7))))
      lut[size_t(k++)] = uint16_t(i);
  uint16_t max_value = uint16_t(k - 1);
  if (n - pos < 4) fail("a PIZ chunk ends before its Huffman length");
  uint32_t length = le32(src + pos);
  pos += 4;
  if (length > n - pos) fail("a PIZ chunk's Huffman length exceeds it");
  huf_uncompress(src + pos, length, tmp.data(), total);
  for (size_t c = 0; c < h.channels.size(); ++c) {
    int size = h.channels[c].bytes() / 2;
    for (int j = 0; j < size; ++j)
      wav2_decode(tmp.data() + start[c] + j, w, size, nl, w * size,
                  max_value);
  }
  for (uint16_t& v : tmp) v = lut[v];
  // planar channels -> lines of channels, little-endian
  uint8_t* o = out;
  for (int y = 0; y < nl; ++y)
    for (size_t c = 0; c < h.channels.size(); ++c) {
      size_t m = size_t(w) * (h.channels[c].bytes() / 2);
      const uint16_t* s = tmp.data() + start[c] + size_t(y) * m;
      for (size_t i = 0; i < m; ++i) {
        *o++ = uint8_t(s[i]);
        *o++ = uint8_t(s[i] >> 8);
      }
    }
}

// ------------------------------------------------------------- pixels

struct HalfTable {
  uint32_t bits[kUShortRange];
  HalfTable() {
    for (uint32_t hv = 0; hv < uint32_t(kUShortRange); ++hv) {
      uint32_t s = (hv & 0x8000u) << 16, e = (hv >> 10) & 31, m = hv & 0x3ff;
      uint32_t f;
      if (e == 0 && m == 0) {
        f = s;
      } else if (e == 0) {     // subnormal: normalise the significand
        int ex = 1;
        while (!(m & 0x400)) {
          m <<= 1;
          --ex;
        }
        f = s | uint32_t(ex + 112) << 23 | (m & 0x3ff) << 13;
      } else if (e == 31) {    // infinity, or NaN with its payload
        f = s | 0x7f800000u | m << 13;
      } else {
        f = s | (e + 112) << 23 | m << 13;
      }
      bits[hv] = f;
    }
  }
};

const HalfTable& half_table() {
  static const HalfTable t;
  return t;
}

void decode(const uint8_t* data, size_t n, float* out) {
  Header h = parse_header(data, n);
  const int lines = h.lines_per_chunk();
  const size_t nchunks = (size_t(h.height) + lines - 1) / lines;
  if (nchunks > (n - h.end) / 8) fail("the file ends inside its offset table");
  const size_t line_bytes = h.line_bytes();
  const int C = h.out_channels();
  const int w = h.width;
  std::vector<size_t> offset(h.channels.size());
  for (size_t c = 0, o = 0; c < h.channels.size(); ++c) {
    offset[c] = o;
    o += size_t(h.channels[c].bytes()) * w;
  }
  const HalfTable& half = half_table();
  std::vector<uint8_t> raw(line_bytes * lines), tmp(line_bytes * lines);
  for (size_t i = 0; i < nchunks; ++i) {
    const uint8_t* t = data + h.end + 8 * i;
    uint64_t at = uint64_t(le32(t)) | uint64_t(le32(t + 4)) << 32;
    if (at < h.end + 8 * nchunks || at > n - 8 || n < 8)
      fail("chunk " + std::to_string(i) + "'s offset " + std::to_string(at) +
           " lies outside the file");
    int32_t y = int32_t(le32(data + at));
    uint32_t size = le32(data + at + 4);
    int64_t want_y = int64_t(h.data.ymin) + int64_t(i) * lines;
    if (y != want_y)
      fail("chunk " + std::to_string(i) + " starts at line " +
           std::to_string(y) + ", not " + std::to_string(want_y));
    if (size > n - at - 8)
      fail("chunk " + std::to_string(i) + " runs past the end of the file");
    const uint8_t* src = data + at + 8;
    int nl = int(std::min<int64_t>(lines, int64_t(h.data.ymax) - y + 1));
    size_t raw_size = line_bytes * nl;
    const uint8_t* pix = raw.data();
    if (size == raw_size) {
      pix = src;       // stored raw, whatever the compression
    } else if (size > raw_size || h.compression == kNone) {
      fail("chunk " + std::to_string(i) + " holds " + std::to_string(size) +
           " bytes for " + std::to_string(raw_size) + " raw");
    } else if (h.compression == kRle) {
      rle_uncompress(src, size, tmp.data(), raw_size);
      unpredict(tmp.data(), raw_size, raw.data());
    } else if (h.compression == kZips || h.compression == kZip) {
      zlib_uncompress(src, size, tmp.data(), raw_size);
      unpredict(tmp.data(), raw_size, raw.data());
    } else {
      piz_uncompress(src, size, h, nl, raw.data());
    }
    for (int l = 0; l < nl; ++l) {
      const uint8_t* line = pix + line_bytes * l;
      float* o = out + (size_t(y - h.data.ymin) + l) * w * C;
      for (int k = 0; k < C; ++k) {
        int c = h.rgba[k];
        const uint8_t* s = line + offset[c];
        if (h.channels[c].type == kHalf) {
          for (int x = 0; x < w; ++x) {
            uint32_t f = half.bits[s[2 * x] | s[2 * x + 1] << 8];
            std::memcpy(o + size_t(x) * C + k, &f, 4);
          }
        } else {
          for (int x = 0; x < w; ++x) {
            uint32_t f = le32(s + 4 * x);
            std::memcpy(o + size_t(x) * C + k, &f, 4);
          }
        }
      }
    }
  }
}

void set_error(char* err, int errlen, const std::string& what) {
  if (err && errlen > 0)
    std::snprintf(err, size_t(errlen), "%s", what.c_str());
}

}  // namespace

extern "C" {

// Height, width and channel count (3 for RGB, 4 with A) of the OpenEXR file
// in data[0:n], from its header. 0 on success; else -1 and a message in err.
int mfx_info(const uint8_t* data, size_t n, int* dims, char* err,
             int errlen) {
  try {
    Header h = parse_header(data, n);
    dims[0] = h.height;
    dims[1] = h.width;
    dims[2] = h.out_channels();
    return 0;
  } catch (const ExrError& e) {
    set_error(err, errlen, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode the OpenEXR file in data[0:n] into out, height * width * channels
// float32 values as mfx_info gives them. 0 on success; else -1 and a
// message in err.
int mfx_decode(const uint8_t* data, size_t n, float* out, char* err,
               int errlen) {
  try {
    decode(data, n, out);
    return 0;
  } catch (const ExrError& e) {
    set_error(err, errlen, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
