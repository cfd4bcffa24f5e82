// JPEG decoder for the port's data loaders: host C++17, a plain C interface
// bound with ctypes (datasets/jpeg.py), no library beyond the C++ standard
// library.
//
// The output is libjpeg's default decode (what libjpeg-turbo, PIL and the
// JAX package's native loader return), bit for bit:
//   * the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) and
//     its post-IDCT range-limit table (jdmaster.c);
//   * fancy upsampling (jdsample.c): the triangle filters h2v1 and h2v2 when
//     the component is more than 2 samples wide, libjpeg-turbo's h1v2,
//     replication otherwise, with the edge rows replicated as jdmainct.c
//     supplies its context rows;
//   * the fixed-point YCbCr -> RGB tables (jdcolor.c, SCALEBITS 16).
//
// It reads baseline and extended-sequential Huffman 8-bit frames and
// progressive ones (spectral selection, successive approximation, EOB runs),
// with one or three components of any integral sampling ratio, restart
// intervals, and the colour space as libjpeg guesses it (JFIF, Adobe APP14
// transform flag, component ids). It refuses arithmetic coding, lossless
// and hierarchical frames, precisions other than 8 bits, two- and
// four-component (CMYK/YCCK) files, DNL, and data that ends or breaks inside
// a scan: it reports why and returns no image. Like libjpeg it ignores EXIF
// orientation.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw JpegError{what}; }

// zigzag position -> natural (row-major) position, with 16 guard entries
// for corrupt run lengths (jutils.c jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  // canonical decoding tables (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  // kLookBits-bit lookahead: (code length << 8) | symbol, 0 when longer
  uint16_t look[1 << kLookBits];
};

void build_huffman(Huffman* h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("a bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0x7FFFFFFF;
  std::memset(h->huffval, 0, sizeof(h->huffval));
  std::memcpy(h->huffval, vals, nvals);
  std::memset(h->look, 0, sizeof(h->look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int lookbits = huffcode[p] << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
        h->look[lookbits++] = uint16_t((l << 8) | vals[p]);
    }
  }
  h->defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks a row and rows of blocks, allocated
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  int dw = 0, dh = 0;          // downsampled width and height in samples
  bool latched = false;
  uint16_t quant[64];          // natural order
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
  int dc_pred = 0;
};

// entropy-coded data: bits, byte stuffing and markers (jdhuff.c)
struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (pos >= n) fail("data that ends inside a scan");
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) ++q;  // fill bytes
          if (q >= n) fail("data that ends inside a scan");
          if (data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // zeros from here, as libjpeg feeds them
            pos = q - 1;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= uint64_t(byte) << (56 - count);
      count += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (count < k) fill();
    int v = int(buf >> (64 - k));
    buf <<= k;
    count -= k;
    return v;
  }
  int get_bit() { return get_bits(1); }
  int decode(const Huffman& h) {
    if (count < 16) fill();
    int look = int(buf >> (64 - kLookBits));
    int e = h.look[look];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      count -= l;
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = int32_t(buf >> (64 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = int32_t(buf >> (64 - l));
    }
    if (l > 16) fail("a corrupt Huffman code");
    buf <<= l;
    count -= l;
    return h.huffval[(code + h.valoffset[l]) & 0xFF];
  }
  void reset() {
    buf = 0;
    count = 0;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  bool progressive = false, have_frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int eobrun = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  int u8() {
    if (pos >= n) fail("data that ends inside a marker segment");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the segment's payload [start, end) after its length field
  size_t segment(size_t* start) {
    int len = u16();
    if (len < 2 || pos + len - 2 > n) fail("a bad marker segment length");
    *start = pos;
    return pos + len - 2;
  }

  void read_dqt() {
    size_t start, end = segment(&start);
    while (pos < end) {
      int pq = u8(), tq = pq & 15;
      pq >>= 4;
      if (tq > 3) fail("a quantization table index over 3");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = uint16_t(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void read_dht() {
    size_t start, end = segment(&start);
    while (pos < end) {
      int tc = u8(), th = tc & 15;
      tc >>= 4;
      if (th > 3 || tc > 1) fail("a bad Huffman table class or index");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(u8());
      if (total > 256 || pos + total > end) fail("a bad Huffman table");
      build_huffman(tc ? &ac[th] : &dc[th], counts, data + pos, total);
      pos += total;
    }
    pos = end;
  }

  void read_sof() {
    if (have_frame) fail("a second frame");
    size_t start, end = segment(&start);
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (only 8-bit is read)");
    height = u16();
    width = u16();
    int nf = u8();
    if (height == 0) fail("a DNL marker (frame height 0)");
    if (width == 0) fail("a frame of width 0");
    if (nf == 4) fail("4 components (CMYK/YCCK)");
    if (nf != 1 && nf != 3)
      fail(std::to_string(nf) + " components (only 1 or 3 are read)");
    comps.resize(nf);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    pos = end;
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("sampling factors whose ratio is not an integer");
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
    }
    have_frame = true;
  }

  void read_app(int marker) {
    size_t start, end = segment(&start);
    size_t len = end - start;
    if (marker == 0xE0 && len >= 14 &&
        !std::memcmp(data + start, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && len >= 12 &&
        !std::memcmp(data + start, "Adobe", 5)) {
      adobe = true;
      adobe_transform = data[start + 11];
    }
    pos = end;
  }

  void alloc_coefs() {
    for (auto& c : comps)
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
  }

  // the next marker code after entropy-coded data, skipping any garbage
  int next_marker() {
    for (;;) {
      while (pos < n && data[pos] != 0xFF) ++pos;
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) return -1;
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_restart(BitReader* br, int* expected) {
    br->reset();
    pos = br->pos;
    if (!br->at_marker) {
      // the marker follows the padding bits of the interval's last byte
      while (pos < n && data[pos] != 0xFF) ++pos;
    }
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n || data[pos] != 0xD0 + *expected)
      fail("a missing or out-of-order restart marker");
    ++pos;
    *expected = (*expected + 1) & 7;
    br->pos = pos;
    br->at_marker = false;
    for (auto& c : comps) c.dc_pred = 0;
    eobrun = 0;
  }

  // one block of a sequential scan
  void decode_block_seq(BitReader* br, Component& c, int16_t* blk,
                        const Huffman& hd, const Huffman& ha) {
    int s = br->decode(hd);
    int diff = s ? extend(br->get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br->decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int val = extend(br->get_bits(s), s);
        blk[kNatural[k]] = int16_t(val);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader* br, Component& c, int16_t* blk,
                       const Huffman& hd, int al) {
    int s = br->decode(hd);
    int diff = s ? extend(br->get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred * (1 << al));
  }

  void decode_dc_refine(BitReader* br, int16_t* blk, int al) {
    if (br->get_bit()) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void decode_ac_first(BitReader* br, int16_t* blk, const Huffman& ha,
                       int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br->decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int val = extend(br->get_bits(s), s);
        blk[kNatural[k]] = int16_t(val * (1 << al));
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br->get_bits(r);
          --eobrun;
          break;
        }
      }
    }
  }

  void decode_ac_refine(BitReader* br, int16_t* blk, const Huffman& ha,
                        int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br->decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br->get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br->get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br->get_bit() && (*coef & p1) == 0)
              *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br->get_bit() && (*coef & p1) == 0)
          *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  void read_sos() {
    if (!have_frame) fail("a scan before the frame header");
    size_t start, end = segment(&start);
    int ns = u8();
    if (ns < 1 || ns > 4) fail("a bad scan header");
    std::vector<Component*> sc;
    std::vector<int> td, ta;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("a scan of an unknown component");
      sc.push_back(found);
      td.push_back(t >> 4);
      ta.push_back(t & 15);
      if ((t >> 4) > 3 || (t & 15) > 3) fail("a bad Huffman table index");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    pos = end;
    alloc_coefs();
    for (Component* c : sc) {
      if (!c->latched) {   // as libjpeg latches at the first scan
        if (!qt_defined[c->tq]) fail("a missing quantization table");
        std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      c->dc_pred = 0;
    }
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13 || (ah && ah - 1 != al))
        fail("a bad progressive scan");
    } else if (ss != 0 || se != 63 || ah || al) {
      fail("a bad sequential scan");
    }
    bool dc_scan = ss == 0;
    for (int i = 0; i < ns; ++i) {
      bool need_dc = dc_scan && !(progressive && ah);
      bool need_ac = !progressive || !dc_scan;
      if (need_dc && !dc[td[i]].defined) fail("a missing Huffman table");
      if (need_ac && !ac[ta[i]].defined) fail("a missing Huffman table");
    }
    eobrun = 0;
    BitReader br{data, n, pos};
    int expected_rst = 0;
    int restarts_left = restart_interval;

    auto one_block = [&](int ci, int16_t* blk) {
      Component& c = *sc[ci];
      if (!progressive) {
        decode_block_seq(&br, c, blk, dc[td[ci]], ac[ta[ci]]);
      } else if (dc_scan) {
        if (ah == 0)
          decode_dc_first(&br, c, blk, dc[td[ci]], al);
        else
          decode_dc_refine(&br, blk, al);
      } else if (ah == 0) {
        decode_ac_first(&br, blk, ac[ta[ci]], ss, se, al);
      } else {
        decode_ac_refine(&br, blk, ac[ta[ci]], ss, se, al);
      }
    };
    auto restart_check = [&](bool last) {
      if (!restart_interval || last) return;
      if (--restarts_left == 0) {
        read_restart(&br, &expected_rst);
        restarts_left = restart_interval;
      }
    };

    if (ns == 1) {   // non-interleaved: the component's own blocks
      Component& c = *sc[0];
      int total = c.wblocks * c.hblocks, done_blocks = 0;
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx) {
          one_block(0, &c.coef[(size_t(by) * c.bw + bx) * 64]);
          restart_check(++done_blocks == total);
        }
    } else {
      int total = mcus_x * mcus_y, done_mcus = 0;
      for (int my = 0; my < mcus_y; ++my)
        for (int mx = 0; mx < mcus_x; ++mx) {
          for (int ci = 0; ci < ns; ++ci) {
            Component& c = *sc[ci];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                size_t b = size_t(my * c.v + y) * c.bw + mx * c.h + x;
                one_block(ci, &c.coef[b * 64]);
              }
          }
          restart_check(++done_mcus == total);
        }
    }
    pos = br.pos;
  }

  void parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();   // skipping garbage, as libjpeg does
      if (m < 0) {
        if (!have_frame) fail("no frame");
        return;   // no EOI after the last scan, which libjpeg also accepts
      }
      switch (m) {
        case 0xD8:
          fail("a second start-of-image marker");
        case 0xC0:
        case 0xC1:
          read_sof();
          break;
        case 0xC2:
          progressive = true;
          read_sof();
          break;
        case 0xC3:
          fail("a lossless frame");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xDE:
        case 0xDF:
          fail("a hierarchical (differential) frame");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCC:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("arithmetic coding");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          size_t start, end = segment(&start);
          restart_interval = u16();
          pos = end;
          break;
        }
        case 0xDA:
          read_sos();
          break;
        case 0xD9:
          if (!have_frame) fail("no frame");
          return;
        case 0xDC:
          fail("a DNL marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;   // a stray restart marker
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {
            size_t start, end = segment(&start);
            pos = end;
          }
      }
    }
  }

  void parse_header_only() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    while (!have_frame) {
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) fail("no frame");
      int m = data[pos++];
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof();
          break;
        case 0xC3:
          fail("a lossless frame");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail("a hierarchical (differential) frame");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("arithmetic coding");
        case 0xD8:
        case 0xD9:
        case 0xDA:
          fail("no frame before the first scan");
        default: {
          if (m >= 0xD0 && m <= 0xD7) break;
          size_t start, end = segment(&start);
          pos = end;
        }
      }
    }
  }

  bool rgb_colorspace() const {
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

// ------------------------------------------------------------ sample stage

// post-IDCT range limit (jdmaster.c prepare_range_limit_table): indexed by
// the descaled value & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int j = 0; j < 1024; ++j) {
      int v;
      if (j < 128) v = 128 + j;
      else if (j < 512) v = 255;
      else if (j < 896) v = 0;
      else v = j - 896;
      t[j] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t descale(int32_t x, int nbits) {
  return (x + (int32_t(1) << (nbits - 1))) >> nbits;
}

// jidctint.c jpeg_idct_islow: one block into 8 rows of 8 samples
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int32_t dcval = int32_t(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int32_t z2 = int32_t(ip[16]) * qp[16], z3 = int32_t(ip[48]) * qp[48];
    int32_t z1 = (z2 + z3) * F0_541196100;
    int32_t tmp2 = z1 + z3 * -F1_847759065;
    int32_t tmp3 = z1 + z2 * F0_765366865;
    z2 = int32_t(ip[0]) * qp[0];
    z3 = int32_t(ip[32]) * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(ip[56]) * qp[56];
    tmp1 = int32_t(ip[40]) * qp[40];
    tmp2 = int32_t(ip[24]) * qp[24];
    tmp3 = int32_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, s);
    wp[56] = descale(tmp10 - tmp3, s);
    wp[8] = descale(tmp11 + tmp2, s);
    wp[48] = descale(tmp11 - tmp2, s);
    wp[16] = descale(tmp12 + tmp1, s);
    wp[40] = descale(tmp12 - tmp1, s);
    wp[24] = descale(tmp13 + tmp0, s);
    wp[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dcval = kRange.t[descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dcval;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * F0_541196100;
    int32_t tmp2 = z1 + z3 * -F1_847759065;
    int32_t tmp3 = z1 + z2 * F0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, s) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, s) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, s) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, s) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, s) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, s) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, s) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, s) & 1023];
  }
}

// a component's samples: every allocated block, bw*8 wide
std::vector<uint8_t> component_plane(const Component& c) {
  size_t stride = size_t(c.bw) * 8;
  std::vector<uint8_t> plane(stride * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                 &plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride);
  return plane;
}

// a component upsampled to the full image, width x height (jdsample.c)
std::vector<uint8_t> upsample(const Component& c, const uint8_t* in,
                              size_t stride, int hmax, int vmax, int width,
                              int height) {
  int rh = hmax / c.h, rv = vmax / c.v;
  std::vector<uint8_t> out(size_t(width) * height);
  // the input row of an output row's nearer and further neighbour, the
  // edge rows replicated as jdmainct.c's context rows are
  auto row = [&](int i) {
    if (i < 0) i = 0;
    if (i > c.dh - 1) i = c.dh - 1;
    return in + size_t(i) * stride;
  };
  // one output row pair's worth of fancy columns need this many outputs
  std::vector<uint8_t> line(size_t(c.dw) * 2 + 16);
  for (int y = 0; y < height; ++y) {
    uint8_t* op = out.data() + size_t(y) * width;
    if (rh == 1 && rv == 1) {
      std::memcpy(op, in + size_t(y) * stride, width);
    } else if (rh == 2 && rv == 1 && c.dw > 2) {   // h2v1_fancy_upsample
      const uint8_t* ip = in + size_t(y) * stride;
      uint8_t* lp = line.data();
      int v = *ip++;
      *lp++ = uint8_t(v);
      *lp++ = uint8_t((v * 3 + ip[0] + 2) >> 2);
      for (int col = c.dw - 2; col > 0; --col) {
        v = (*ip++) * 3;
        *lp++ = uint8_t((v + ip[-2] + 1) >> 2);
        *lp++ = uint8_t((v + ip[0] + 2) >> 2);
      }
      v = *ip;
      *lp++ = uint8_t((v * 3 + ip[-1] + 1) >> 2);
      *lp++ = uint8_t(v);
      std::memcpy(op, line.data(), width);
    } else if (rh == 1 && rv == 2) {                // h1v2_fancy_upsample
      int i = y >> 1;
      const uint8_t* p0 = row(i);
      const uint8_t* p1 = row((y & 1) ? i + 1 : i - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        op[x] = uint8_t((p0[x] * 3 + p1[x] + bias) >> 2);
    } else if (rh == 2 && rv == 2 && c.dw > 2) {   // h2v2_fancy_upsample
      int i = y >> 1;
      const uint8_t* p0 = row(i);
      const uint8_t* p1 = row((y & 1) ? i + 1 : i - 1);
      uint8_t* lp = line.data();
      int this_sum = (*p0++) * 3 + (*p1++);
      int next_sum = (*p0++) * 3 + (*p1++);
      *lp++ = uint8_t((this_sum * 4 + 8) >> 4);
      *lp++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int col = c.dw - 2; col > 0; --col) {
        next_sum = (*p0++) * 3 + (*p1++);
        *lp++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        *lp++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *lp++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      *lp++ = uint8_t((this_sum * 4 + 7) >> 4);
      std::memcpy(op, line.data(), width);
    } else {   // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const uint8_t* ip = in + size_t(y / rv) * stride;
      for (int x = 0; x < width; ++x) op[x] = ip[x / rh];
    }
  }
  return out;
}

// jdcolor.c ycc_rgb_convert's tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
    auto fix = [](double x) { return int32_t(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void decode(const uint8_t* data, size_t n, uint8_t* out) {
  Decoder d{data, n};
  d.parse();
  if (d.comps[0].coef.empty()) fail("no scan");
  for (auto& c : d.comps)
    if (c.coef.empty()) fail("a component that no scan codes");
  int w = d.width, h = d.height;
  std::vector<std::vector<uint8_t>> full;
  for (auto& c : d.comps) {
    std::vector<uint8_t> plane = component_plane(c);
    full.push_back(upsample(c, plane.data(), size_t(c.bw) * 8, d.hmax,
                            d.vmax, w, h));
  }
  size_t npix = size_t(w) * h;
  if (d.comps.size() == 1) {
    std::memcpy(out, full[0].data(), npix);
    return;
  }
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                *p2 = full[2].data();
  if (d.rgb_colorspace()) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return;
  }
  for (size_t i = 0; i < npix; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
}

void set_error(char* err, int errlen, const std::string& what) {
  if (err && errlen > 0)
    std::snprintf(err, size_t(errlen), "%s", what.c_str());
}

}  // namespace

extern "C" {

// Width, height and channel count (1 or 3) of the JPEG in data[0:n], from
// its frame header. 0 on success; else -1 and a message in err.
int mfj_info(const uint8_t* data, size_t n, int* dims, char* err,
             int errlen) {
  try {
    Decoder d{data, n};
    d.parse_header_only();
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = int(d.comps.size());
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode the JPEG in data[0:n] into out, height * width * channels bytes as
// mfj_info gives them. 0 on success; else -1 and a message in err.
int mfj_decode(const uint8_t* data, size_t n, uint8_t* out, char* err,
               int errlen) {
  try {
    decode(data, n, out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
