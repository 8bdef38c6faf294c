// Baseline JPEG decoder (host C++), built by utils/jpeg.py with g++ and
// loaded with ctypes.  It gives the bytes libjpeg-turbo gives with its
// default settings (the islow IDCT, fancy upsampling, the fixed-point
// YCbCr->RGB tables), which is what PIL's Image.open(p).convert(...)
// reads:
//   - SOF0/SOF1 at 8-bit precision, one interleaved scan;
//   - one component, or three at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2);
//   - 8- and 16-bit quantisation tables, restart intervals.
// Every other kind is refused with a message (the caller raises).
//
// C interface:
//   int jpeg_info(data, n, int out[3], char *err, int errlen)
//       -> 0 and {height, width, channels}, or -1 and a message
//   int jpeg_decode(data, n, uint8 *out, char *err, int errlen)
//       -> 0 and the image, uint8 [height, width, channels]

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a run past the last coefficient of a corrupt block lands here
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[1 << 9];
};

void build_huffman(Huffman &h, const uint8_t *bits, const uint8_t *vals,
                   int nvals) {
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  std::memset(h.look, 0, sizeof(h.look));
  for (int len = 1; len <= 16; ++len) {
    int n = bits[len - 1];
    if (n) {
      h.valoffset[len] = k - code;
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            h.look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    if (code > (1 << len)) fail("bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;  // sentinel: a code longer than 16 bits
  h.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks across and down in the decoded plane
  int dw = 0, dh = 0;  // downsampled width and height (real samples)
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples
  int pred = 0;
};

struct Frame {
  int height = 0, width = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;
  bool seen_sof = false, seen_sos = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

// Entropy-coded data: bytes with FF00 stuffing; a marker stops the feed
// and zeros follow, as libjpeg does.
struct BitReader {
  const uint8_t *data;
  size_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t p = pos + 1;
          while (p < n && data[p] == 0xFF) ++p;  // fill bytes
          if (p < n && data[p] == 0x00) {
            pos = p + 1;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  int peek(int k) {
    if (bits < k) fill();
    return (int)(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    bits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const Huffman &h) {
    int look = h.look[peek(9)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int code = peek(16);
    int len = 10;
    while ((code >> (16 - len)) > h.maxcode[len]) ++len;
    if (len > 16) fail("corrupt entropy-coded data (bad Huffman code)");
    skip(len);
    return h.vals[(code >> (16 - len)) + h.valoffset[len]];
  }
  // the RSTn marker that ends an interval: drop the padding bits, match
  // the marker and go on after it
  void restart(int expect) {
    acc = 0;
    bits = 0;
    at_marker = false;
    while (pos < n) {  // the interval's last (padding) bytes
      if (data[pos] != 0xFF) {
        ++pos;
      } else if (pos + 1 < n && data[pos + 1] == 0x00) {
        pos += 2;
      } else {
        break;
      }
    }
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n || data[pos] != 0xD0 + expect)
      fail("corrupt entropy-coded data (missing RST" +
           std::to_string(expect) + " marker)");
    ++pos;
  }
  // the offset of the marker that ends the scan
  size_t end_offset() {
    size_t p = pos;
    while (p < n) {
      if (data[p] == 0xFF && p + 1 < n && data[p + 1] != 0x00 &&
          data[p + 1] != 0xFF)
        return p;
      ++p;
    }
    return n;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c (jpeg_idct_islow): two passes of the LL&M IDCT in 13-bit
// fixed point, PASS1_BITS 2, then the range limit (libjpeg's post-IDCT
// table indexed by value & 1023).
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

void idct_islow(const int32_t *in, uint8_t *out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t *p = in + c;
    int64_t *w = ws + c;
    if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
      int64_t dc = (int64_t)p[0] << PASS1_BITS;
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = p[16], z3 = p[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = p[0];
    z3 = p[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = p[56];
    tmp1 = p[40];
    tmp2 = p[24];
    tmp3 = p[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int32_t)descale(tmp10 + tmp3, sh);
    w[56] = (int32_t)descale(tmp10 - tmp3, sh);
    w[8] = (int32_t)descale(tmp11 + tmp2, sh);
    w[48] = (int32_t)descale(tmp11 - tmp2, sh);
    w[16] = (int32_t)descale(tmp12 + tmp1, sh);
    w[40] = (int32_t)descale(tmp12 - tmp1, sh);
    w[24] = (int32_t)descale(tmp13 + tmp0, sh);
    w[32] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

const char *sof_name(int m) {
  switch (m) {
    case 0xC2: return "progressive (SOF2)";
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5, hierarchical)";
    case 0xC6: return "differential progressive (SOF6, hierarchical)";
    case 0xC7: return "differential lossless (SOF7, hierarchical)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
  }
  return nullptr;
}

void read_sof(Frame &f, const uint8_t *p, int len) {
  if (f.seen_sof) fail("more than one SOF marker");
  if (len < 6) fail("truncated SOF marker");
  if (p[0] != 8)
    fail(std::to_string(p[0]) + "-bit precision is not read (8-bit only)");
  f.height = u16(p + 1);
  f.width = u16(p + 3);
  int nc = p[5];
  if (f.height == 0)
    fail("a height defined by a DNL marker is not read");
  if (f.width == 0) fail("zero image width");
  if (nc == 4) fail("four-component (CMYK/YCCK) JPEG is not read");
  if (nc != 1 && nc != 3)
    fail(std::to_string(nc) + "-component JPEG is not read");
  if (len < 6 + 3 * nc) fail("truncated SOF marker");
  for (int i = 0; i < nc; ++i) {
    Component c;
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i];
    if (c.tq > 3) fail("bad quantisation table selector");
    f.comps.push_back(c);
  }
  // one component: a non-interleaved scan at full size, whatever its
  // sampling factors say
  if (nc == 3) {
    const Component &y = f.comps[0];
    bool chroma_1x1 = f.comps[1].h == 1 && f.comps[1].v == 1 &&
                      f.comps[2].h == 1 && f.comps[2].v == 1;
    bool ok = chroma_1x1 && ((y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) ||
                             (y.h == 2 && y.v == 2));
    if (!ok) {
      char buf[96];
      std::snprintf(buf, sizeof buf,
                    "sampling %dx%d,%dx%d,%dx%d is not read (4:4:4, 4:2:2 "
                    "and 4:2:0 only)",
                    y.h, y.v, f.comps[1].h, f.comps[1].v, f.comps[2].h,
                    f.comps[2].v);
      fail(buf);
    }
  }
  for (auto &c : f.comps) {
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
      fail("bad sampling factors");
    f.hmax = std::max(f.hmax, c.h);
    f.vmax = std::max(f.vmax, c.v);
  }
  f.seen_sof = true;
}

void read_dqt(Frame &f, const uint8_t *p, int len) {
  int off = 0;
  while (off < len) {
    int pq = p[off] >> 4, tq = p[off] & 15;
    ++off;
    if (tq > 3 || pq > 1) fail("bad DQT marker");
    int size = pq ? 128 : 64;
    if (off + size > len) fail("truncated DQT marker");
    for (int k = 0; k < 64; ++k)
      f.quant[tq][kNatural[k]] =
          pq ? (uint16_t)u16(p + off + 2 * k) : p[off + k];
    f.quant_defined[tq] = true;
    off += size;
  }
}

void read_dht(Frame &f, const uint8_t *p, int len) {
  int off = 0;
  while (off < len) {
    if (off + 17 > len) fail("truncated DHT marker");
    int tc = p[off] >> 4, th = p[off] & 15;
    if (tc > 1 || th > 3) fail("bad DHT marker");
    const uint8_t *bits = p + off + 1;
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[i];
    if (total > 256 || off + 17 + total > len) fail("bad DHT marker");
    build_huffman(tc ? f.ac[th] : f.dc[th], bits, p + off + 17, total);
    off += 17 + total;
  }
}

void decode_block(BitReader &br, const Frame &f, Component &c, uint8_t *out,
                  int stride) {
  int32_t coef[64];
  std::memset(coef, 0, sizeof coef);
  const uint16_t *q = f.quant[c.tq];
  int s = br.decode(f.dc[c.td]);
  int diff = s ? extend(br.get(s), s) : 0;
  c.pred += diff;
  coef[0] = c.pred * q[0];
  const Huffman &ac = f.ac[c.ta];
  for (int k = 1; k < 64;) {
    int rs = br.decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int pos = kNatural[k];
      coef[pos] = extend(br.get(s), s) * q[pos];
      ++k;
    } else {
      if (r != 15) break;  // EOB
      k += 16;
    }
  }
  idct_islow(coef, out, stride);
}

size_t decode_scan(Frame &f, const uint8_t *data, size_t n, size_t pos) {
  int nc = (int)f.comps.size();
  int mcux, mcuy;
  if (nc == 1) {
    mcux = (f.width + 7) / 8;
    mcuy = (f.height + 7) / 8;
  } else {
    mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  }
  for (auto &c : f.comps) {
    if (!f.quant_defined[c.tq]) fail("a quantisation table is missing");
    if (!f.dc[c.td].defined || !f.ac[c.ta].defined)
      fail("a Huffman table is missing");
    c.bw = nc == 1 ? mcux : mcux * c.h;
    c.bh = nc == 1 ? mcuy : mcuy * c.v;
    c.dw = (f.width * c.h + f.hmax - 1) / f.hmax;
    c.dh = (f.height * c.v + f.vmax - 1) / f.vmax;
    c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    c.pred = 0;
  }
  BitReader br{data, n, pos};
  int todo = f.restart_interval, next_rst = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (f.restart_interval && todo == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        todo = f.restart_interval;
        for (auto &c : f.comps) c.pred = 0;
      }
      for (auto &c : f.comps) {
        int stride = c.bw * 8;
        int bh = nc == 1 ? 1 : c.h, bv = nc == 1 ? 1 : c.v;
        for (int by = 0; by < bv; ++by)
          for (int bx = 0; bx < bh; ++bx) {
            size_t row = (size_t)(my * bv + by) * 8;
            size_t col = (size_t)(mx * bh + bx) * 8;
            decode_block(br, f, c, c.plane.data() + row * stride + col,
                         stride);
          }
      }
      --todo;
    }
  }
  return br.end_offset();
}

Frame parse(const uint8_t *data, size_t n, bool decode) {
  Frame f;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
  size_t pos = 2;
  while (true) {
    // find the next marker, skipping fill bytes
    if (pos >= n || data[pos] != 0xFF)
      fail(f.seen_sos ? "no EOI marker after the scan"
                      : "truncated or corrupt JPEG (no marker where one "
                        "belongs)");
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) fail("truncated JPEG");
    int m = data[pos++];
    if (m == 0xD9) {  // EOI
      if (!f.seen_sos) fail("no image data (EOI before SOS)");
      return f;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7))
      fail("stray marker outside the entropy-coded data");
    if (pos + 2 > n) fail("truncated JPEG");
    int len = u16(data + pos) - 2;
    if (len < 0 || pos + 2 + len > n) fail("truncated JPEG marker");
    const uint8_t *p = data + pos + 2;
    pos += 2 + len;
    if (m == 0xC0 || m == 0xC1) {
      read_sof(f, p, len);
    } else if (const char *kind = sof_name(m)) {
      fail(std::string(kind) + " JPEG is not read (baseline and extended "
                               "sequential Huffman only)");
    } else if (m == 0xCC) {
      fail("arithmetic coding (DAC marker) is not read");
    } else if (m == 0xC4) {
      read_dht(f, p, len);
    } else if (m == 0xDB) {
      read_dqt(f, p, len);
    } else if (m == 0xDD) {
      if (len < 2) fail("truncated DRI marker");
      f.restart_interval = u16(p);
    } else if (m == 0xE0) {
      if (len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) f.saw_jfif = true;
    } else if (m == 0xEE) {
      if (len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        f.saw_adobe = true;
        f.adobe_transform = p[11];
      }
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
      // other APPn and COM: skipped
    } else if (m == 0xDA) {
      if (!f.seen_sof) fail("SOS before SOF");
      if (f.seen_sos)
        fail("sequential JPEG of more than one scan is not read");
      int ns = len > 0 ? p[0] : 0;
      if (len < 1 + 2 * ns + 3) fail("truncated SOS marker");
      if (ns != (int)f.comps.size())
        fail("sequential JPEG of more than one scan is not read");
      for (int i = 0; i < ns; ++i) {
        int id = p[1 + 2 * i];
        Component *c = nullptr;
        for (auto &cc : f.comps)
          if (cc.id == id) c = &cc;
        if (!c || c != &f.comps[i]) fail("bad component in SOS");
        c->td = p[2 + 2 * i] >> 4;
        c->ta = p[2 + 2 * i] & 15;
        if (c->td > 3 || c->ta > 3) fail("bad Huffman table selector");
      }
      f.seen_sos = true;
      if (!decode) return f;
      pos = decode_scan(f, data, n, pos);
    } else {
      char buf[64];
      std::snprintf(buf, sizeof buf, "unsupported marker 0xFF%02X", m);
      fail(buf);
    }
  }
}

bool is_rgb(const Frame &f) {
  if (f.comps.size() != 3) return false;
  if (f.saw_jfif) return false;
  if (f.saw_adobe) return f.adobe_transform == 0;
  return f.comps[0].id == 'R' && f.comps[1].id == 'G' && f.comps[2].id == 'B';
}

// jdsample.c: one component's samples at full size, row y of the output.
// Fancy upsampling (a triangle filter) where libjpeg uses it, i.e. for a
// component more than 2 samples wide, else replication.
void upsample_row(const Frame &f, const Component &c, int y, int *out) {
  int stride = c.bw * 8, W = f.width;
  if (c.h == f.hmax && c.v == f.vmax) {
    const uint8_t *r = c.plane.data() + (size_t)y * stride;
    for (int x = 0; x < W; ++x) out[x] = r[x];
    return;
  }
  bool fancy = c.dw > 2;
  if (f.vmax == 1) {  // h2v1
    const uint8_t *r = c.plane.data() + (size_t)y * stride;
    if (!fancy) {
      for (int x = 0; x < W; ++x) out[x] = r[x >> 1];
      return;
    }
    for (int x = 0; x < W; ++x) {
      int i = x >> 1;
      if (x & 1)
        out[x] = i == c.dw - 1 ? r[i] : (r[i] * 3 + r[i + 1] + 2) >> 2;
      else
        out[x] = i == 0 ? r[0] : (r[i] * 3 + r[i - 1] + 1) >> 2;
    }
    return;
  }
  // h2v2
  int iy = y >> 1;
  const uint8_t *r0 = c.plane.data() + (size_t)iy * stride;
  if (!fancy) {
    for (int x = 0; x < W; ++x) out[x] = r0[x >> 1];
    return;
  }
  int ny = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
  const uint8_t *r1 = c.plane.data() + (size_t)ny * stride;
  auto colsum = [&](int i) { return r0[i] * 3 + r1[i]; };
  for (int x = 0; x < W; ++x) {
    int i = x >> 1;
    int t = colsum(i);
    if (x & 1)
      out[x] = i == c.dw - 1 ? (t * 4 + 7) >> 4 : (t * 3 + colsum(i + 1) + 7) >> 4;
    else
      out[x] = i == 0 ? (t * 4 + 8) >> 4 : (t * 3 + colsum(i - 1) + 8) >> 4;
  }
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void write_image(const Frame &f, uint8_t *out) {
  int W = f.width, H = f.height;
  if (f.comps.size() == 1) {
    const Component &c = f.comps[0];
    for (int y = 0; y < H; ++y)
      std::memcpy(out + (size_t)y * W, c.plane.data() + (size_t)y * c.bw * 8, W);
    return;
  }
  // jdcolor.c: 16-bit fixed-point tables, rounded with ONE_HALF
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  bool rgb = is_rgb(f);
  std::vector<int> c0(W), c1(W), c2(W);
  for (int y = 0; y < H; ++y) {
    upsample_row(f, f.comps[0], y, c0.data());
    upsample_row(f, f.comps[1], y, c1.data());
    upsample_row(f, f.comps[2], y, c2.data());
    uint8_t *o = out + (size_t)y * W * 3;
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = (uint8_t)c0[x];
        o[3 * x + 1] = (uint8_t)c1[x];
        o[3 * x + 2] = (uint8_t)c2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp255(yy + cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      o[3 * x + 2] = clamp255(yy + cb_b[cb]);
    }
  }
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (errlen <= 0) return;
  std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t *data, long long n, int *out, char *err,
              int errlen) {
  try {
    Frame f = parse(data, (size_t)n, false);
    out[0] = f.height;
    out[1] = f.width;
    out[2] = (int)f.comps.size();
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

int jpeg_decode(const uint8_t *data, long long n, uint8_t *out, char *err,
                int errlen) {
  try {
    Frame f = parse(data, (size_t)n, true);
    write_image(f, out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc &) {
    set_error(err, errlen, "out of memory");
    return -1;
  }
}

}  // extern "C"
