// kdlt image decode: JPEG and the PNG row filters, without PIL.
//
// The JAX package decodes with PIL (ops/preprocess.py::decode_image), which
// decodes JPEG with libjpeg-turbo's defaults.  This decoder follows those
// defaults step by step so that its pixels are byte-equal to
// PIL.Image.open(...).convert("RGB"):
//
// - Huffman decode of baseline and extended-sequential (SOF0/SOF1) 8-bit
//   scans, interleaved or not, with restart intervals;
// - progressive (SOF2) scans as jdphuff.c decodes them: DC first and DC
//   refinement, AC first with end-of-band runs, AC refinement with its
//   correction bits, into a coefficient buffer over the whole frame
//   (jdcoefct.c's multi-scan mode), inverse-transformed after the last
//   scan;
// - the integer "islow" inverse DCT of jidctint.c (13-bit constants, two
//   passes, PASS1_BITS = 2) and its post-IDCT range-limit table;
// - the upsampling of jdsample.c with "fancy" upsampling on: the triangle
//   filters for h2v1 (4:2:2), h2v2 (4:2:0) and h1v2 (4:4:0) with their
//   rounding biases and edge rules, plain replication where libjpeg-turbo
//   takes it (h2v1 and h2v2 components two or fewer samples wide, and every
//   other integral ratio, such as h4v1, 4:1:1);
// - the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits);
// - 4-component frames as PIL reads them: libjpeg's CMYK output (YCCK
//   turned into CMYK first, as jdcolor.c does for an Adobe transform other
//   than 0), inverted (PIL's "CMYK;I"), then Pillow's own CMYK -> RGB
//   (libImaging/Convert.c cmyk2rgb).
//
// Arithmetic-coded, lossless, hierarchical and 12-bit JPEGs, fractional
// sampling ratios, and a progressive file whose scans leave one of the
// first ten coefficients unrefined (libjpeg-turbo would then apply its
// block smoothing, jdcoefct.c decompress_smooth_data, which this decoder
// does not) are refused with a message naming what is unsupported.  So is
// a frame of more than kMaxPixels pixels, PIL's decompression-bomb bound,
// before anything of its size is allocated: the header alone never
// allocates.
//
// PNG's inflate stays in Python (zlib); kdlt_png_unfilter undoes the five
// row filters here, where the per-byte loops are cheap.
//
// Every entry point is plain C (bound with ctypes, which releases the
// interpreter lock for the call).  Errors return non-zero and write a
// message into the caller's buffer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// Natural order of the zig-zag sequence (jutils.c jpeg_natural_order).
constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The same with 16 extra entries (jutils.c keeps them too): a corrupt
// progressive run past the band lands on coefficient 63, as in libjpeg.
struct NaturalExt {
  int t[80];
  NaturalExt() {
    for (int i = 0; i < 80; ++i) t[i] = i < 64 ? kZigzag[i] : 63;
  }
};
const NaturalExt kNatural;

constexpr int kLookBits = 9;

// PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS pixels
// (DecompressionBombError) before it decodes.
constexpr int64_t kMaxPixels = 2 * int64_t{89478485};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 = slow path
};

void build_huffman(Huffman& t, const uint8_t bits[17], const uint8_t* vals, int nvals) {
  // jdhuff.c jpeg_make_d_derived_tbl: canonical codes by length.
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) size[p++] = static_cast<uint8_t>(l);
  size[p] = 0;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) fail("corrupt JPEG: bad Huffman table");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += bits[l];
      t.maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7fffffff;
  std::memcpy(t.vals, vals, nvals);
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const uint32_t base = code[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
        t.look[base + k] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  t.defined = true;
}

// Entropy-coded segment reader: strips 0xFF00 stuffing, stops at a marker
// and feeds zeros past it (libjpeg's rule); reading past the real bits is
// a truncated image.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;
  int64_t real_bits = 0;
  int64_t used_bits = 0;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint32_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
        if (!at_marker) real_bits += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
    used_bits += n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& t) {
    const uint32_t look = t.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    const uint32_t bits16 = peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(bits16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }
  void check() const {
    if (used_bits > real_bits) fail("truncated JPEG: entropy-coded data ends early");
  }
  // At a restart boundary: drop the buffered padding bits, consume RSTn.
  void restart(int expect) {
    buf = 0;
    cnt = 0;
    if (!at_marker) {
      while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF)) ++p;
      while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    }
    if (p + 1 >= end || p[0] != 0xFF || p[1] != 0xD0 + expect)
      fail("corrupt JPEG: missing restart marker");
    p += 2;
    at_marker = false;
    real_bits = used_bits = 0;
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

// The DC predictor plus a difference; past int's range is a corrupt file
// (libjpeg's JERR_BAD_DCT_COEF), never an overflow.
inline int add_dc(int pred, int diff) {
  const int64_t v = int64_t{pred} + diff;
  if (v > INT32_MAX || v < INT32_MIN) fail("corrupt JPEG: DC coefficient out of range");
  return static_cast<int>(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks per line / column, padded to whole MCUs
  int dw = 0, dh = 0;  // downsampled width / height in samples
  int stride = 0;
  bool seen = false;  // in a scan; its quantization table is latched then
  int dc_pred = 0;
  uint16_t quant[64] = {};  // natural order, latched at the component's first scan
  std::vector<uint8_t> plane;
  // Progressive only: the frame's coefficients (bw x bh blocks of 64, in
  // natural order, libjpeg's 16-bit JCOEF), and for each coefficient the Al
  // of the last scan that coded it (-1: none), jdphuff.c's coef_bits.
  std::vector<int16_t> coef;
  int coef_bits[64];
};

// The post-IDCT range limit of jdmaster.c prepare_range_limit_table, indexed
// by (x & 1023) for an IDCT output x centred on 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? static_cast<uint8_t>(i + 128) : i < 512 ? 255 : i < 896 ? 0
                                                                                 : static_cast<uint8_t>(i - 896);
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

template <typename Coef>
void idct_islow(const Coef* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int col = 0; col < 8; ++col) {
    const Coef* in = coef + col;
    const uint16_t* q = quant + col;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int64_t dc = static_cast<int64_t>(in[0]) * q[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * q[16];
    int64_t z3 = static_cast<int64_t>(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * q[0];
    z3 = static_cast<int64_t>(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * q[56];
    tmp1 = static_cast<int64_t>(in[40]) * q[40];
    tmp2 = static_cast<int64_t>(in[24]) * q[24];
    tmp3 = static_cast<int64_t>(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + col] = static_cast<int32_t>(descale(tmp10 + tmp3, sh));
    ws[7 * 8 + col] = static_cast<int32_t>(descale(tmp10 - tmp3, sh));
    ws[1 * 8 + col] = static_cast<int32_t>(descale(tmp11 + tmp2, sh));
    ws[6 * 8 + col] = static_cast<int32_t>(descale(tmp11 - tmp2, sh));
    ws[2 * 8 + col] = static_cast<int32_t>(descale(tmp12 + tmp1, sh));
    ws[5 * 8 + col] = static_cast<int32_t>(descale(tmp12 - tmp1, sh));
    ws[3 * 8 + col] = static_cast<int32_t>(descale(tmp13 + tmp0, sh));
    ws[4 * 8 + col] = static_cast<int32_t>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    const int64_t* w = ws + row * 8;
    uint8_t* o = out + row * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, int64_t len) : d_(data), len_(len) {}

  // Parses up to the frame header; fills width/height/components.  The
  // component planes are allocated by decode(), not here.
  void header() {
    if (len_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (frame_marker(m)) return;
      if (m == 0xD9) fail("corrupt JPEG: no frame header before EOI");
      segment(m);
    }
  }

  void decode(uint8_t* out) {
    header();
    for (auto& c : comps_) {
      c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
      if (progressive_) {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
    bool scanned = false;
    for (;;) {
      const int m = pos_ < len_ ? next_marker() : 0xD9;
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        scanned = true;
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        fail("unsupported JPEG: more than one frame");
      } else {
        segment(m);
      }
    }
    if (!scanned) fail("corrupt JPEG: no scan");
    for (auto& c : comps_)
      if (!c.seen) fail("corrupt JPEG: a component has no scan");
    if (progressive_) {
      if (smoothing_wanted())
        fail("unsupported JPEG: progressive scans leave low-frequency coefficients unrefined "
             "(libjpeg's block smoothing is not supported)");
      for (auto& c : comps_) {
        const int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
        for (int r = 0; r < rows; ++r)
          for (int b = 0; b < cols; ++b)
            idct_islow(c.coef.data() + (static_cast<size_t>(r) * c.bw + b) * 64, c.quant,
                       c.plane.data() + static_cast<size_t>(r) * 8 * c.stride + b * 8, c.stride);
      }
    }
    convert(out);
  }

  int width = 0, height = 0;

 private:
  const uint8_t* d_;
  int64_t len_;
  int64_t pos_ = 0;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  bool progressive_ = false;
  int eobrun_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];

  int next_marker() {
    while (pos_ < len_ && d_[pos_] != 0xFF) ++pos_;  // garbage before a marker
    while (pos_ < len_ && d_[pos_] == 0xFF) ++pos_;   // fill bytes
    if (pos_ >= len_) fail("truncated JPEG: no EOI marker");
    return d_[pos_++];
  }

  const uint8_t* payload(int64_t* n) {
    if (pos_ + 2 > len_) fail("truncated JPEG: segment header");
    const int64_t l = be16(d_ + pos_);
    if (l < 2 || pos_ + l > len_) fail("truncated JPEG: segment");
    const uint8_t* p = d_ + pos_ + 2;
    *n = l - 2;
    pos_ += l;
    return p;
  }

  bool frame_marker(int m) {
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        progressive_ = m == 0xC2;
        frame();
        return true;
      case 0xC3:
        fail("unsupported JPEG: lossless (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("unsupported JPEG: hierarchical (SOF5-7) is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("unsupported JPEG: arithmetic coding (SOF9-15) is not supported");
      default:
        return false;
    }
  }

  void segment(int m) {
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD8)) return;  // standalone markers
    int64_t n;
    const uint8_t* p = payload(&n);
    switch (m) {
      case 0xC4:
        dht(p, n);
        break;
      case 0xDB:
        dqt(p, n);
        break;
      case 0xDD:
        if (n < 2) fail("corrupt JPEG: DRI");
        restart_interval_ = be16(p);
        break;
      case 0xCC:
        fail("unsupported JPEG: arithmetic coding (DAC) is not supported");
      case 0xDC:
        fail("unsupported JPEG: DNL marker is not supported");
      case 0xE0:
        if (n >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        if (n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = p[11];
        }
        break;
      default:
        break;  // APPn, COM, ...: skipped
    }
  }

  void dht(const uint8_t* p, int64_t n) {
    while (n > 0) {
      if (n < 17) fail("corrupt JPEG: DHT");
      const int tc = p[0] >> 4, th = p[0] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: DHT table id");
      uint8_t bits[17] = {};
      int total = 0;
      for (int i = 1; i <= 16; ++i) total += bits[i] = p[i];
      if (total > 256 || 17 + total > n) fail("corrupt JPEG: DHT counts");
      build_huffman(tc ? ac_[th] : dc_[th], bits, p + 17, total);
      p += 17 + total;
      n -= 17 + total;
    }
  }

  void dqt(const uint8_t* p, int64_t n) {
    while (n > 0) {
      const int pq = p[0] >> 4, tq = p[0] & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: DQT");
      const int need = 1 + 64 * (pq + 1);
      if (n < need) fail("corrupt JPEG: DQT length");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kZigzag[k]] = pq ? be16(p + 1 + 2 * k) : p[1 + k];
      qt_defined_[tq] = true;
      p += need;
      n -= need;
    }
  }

  void frame() {
    int64_t n;
    const uint8_t* p = payload(&n);
    if (n < 6) fail("corrupt JPEG: SOF");
    if (p[0] != 8) fail("unsupported JPEG: " + std::to_string(p[0]) + "-bit samples (8-bit only)");
    height = be16(p + 1);
    width = be16(p + 3);
    const int nc = p[5];
    if (height == 0) fail("unsupported JPEG: DNL-defined height is not supported");
    if (width == 0) fail("corrupt JPEG: zero width");
    if (static_cast<int64_t>(width) * height > kMaxPixels)
      fail("image too large: " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels exceeds the limit of " + std::to_string(kMaxPixels));
    if (nc != 1 && nc != 3 && nc != 4)
      fail("unsupported JPEG: " + std::to_string(nc) + " components (1, 3 or 4 only)");
    if (n < 6 + 3 * nc) fail("corrupt JPEG: SOF length");
    comps_.assign(nc, Component{});
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: sampling factors");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    for (auto& c : comps_)
      if (hmax_ % c.h || vmax_ % c.v)
        fail("unsupported JPEG: fractional sampling ratios (" + std::to_string(hmax_) + "/" +
             std::to_string(c.h) + " x " + std::to_string(vmax_) + "/" + std::to_string(c.v) +
             ")");
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax_ - 1) / vmax_);
      c.stride = c.bw * 8;
    }
  }

  void decode_block(BitReader& br, Component& c, int brow, int bcol) {
    int32_t coef[64] = {};
    const Huffman& dc = dc_[c.td];
    const Huffman& ac = ac_[c.ta];
    const int s = br.decode(dc);
    if (s > 15) fail("corrupt JPEG: DC magnitude");
    c.dc_pred = add_dc(c.dc_pred, extend(br.get(s), s));
    coef[0] = c.dc_pred;
    for (int k = 1; k < 64;) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) fail("corrupt JPEG: AC run past the block");
        coef[kZigzag[k]] = extend(br.get(sz), sz);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, c.quant, c.plane.data() + static_cast<size_t>(brow) * 8 * c.stride + bcol * 8,
               c.stride);
  }

  void scan() {
    int64_t n;
    const uint8_t* p = payload(&n);
    if (comps_.empty()) fail("corrupt JPEG: SOS before SOF");
    if (n < 1) fail("corrupt JPEG: SOS");
    const int ns = p[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * ns) fail("corrupt JPEG: SOS length");
    const uint8_t* sp = p + 1 + 2 * ns;
    const int ss = sp[0], se = sp[1], ah = sp[2] >> 4, al = sp[2] & 15;
    if (!progressive_ && (ss != 0 || se != 63 || ah != 0 || al != 0))
      fail("corrupt JPEG: spectral selection in a sequential scan");
    // jdphuff.c start_pass_phuff_decoder's checks.
    if (progressive_ && ((ss == 0 && se != 0) || (ss != 0 && (ss > se || se > 63 || ns != 1)) ||
                         (ah != 0 && al != ah - 1) || al > 13))
      fail("corrupt JPEG: invalid progressive scan parameters");
    const bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    const bool need_ac = !progressive_ || ss != 0;
    std::vector<Component*> sc;
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      Component* found = nullptr;
      for (auto& c : comps_)
        if (c.id == p[1 + 2 * i]) found = &c;
      if (!found) fail("corrupt JPEG: SOS names an unknown component");
      found->td = p[2 + 2 * i] >> 4;
      found->ta = p[2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3 || (need_dc && !dc_[found->td].defined) ||
          (need_ac && !ac_[found->ta].defined))
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      if (!found->seen) {  // jdinput.c latch_quant_tables: once, at the first scan
        if (!qt_defined_[found->tq]) fail("corrupt JPEG: undefined quantization table");
        std::memcpy(found->quant, qt_[found->tq], sizeof(found->quant));
      }
      found->dc_pred = 0;
      found->seen = true;
      if (progressive_)
        for (int k = ss; k <= se; ++k) found->coef_bits[k] = al;
      blocks += found->h * found->v;
      sc.push_back(found);
    }
    if (ns > 1 && blocks > 10) fail("corrupt JPEG: more than 10 blocks in an MCU");
    eobrun_ = 0;
    BitReader br{d_ + pos_, d_ + len_};
    int mx, my;
    if (ns == 1) {
      mx = (sc[0]->dw + 7) / 8;
      my = (sc[0]->dh + 7) / 8;
    } else {
      mx = mcux_;
      my = mcuy_;
    }
    const int64_t total = static_cast<int64_t>(mx) * my;
    int rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && m && m % restart_interval_ == 0) {
        br.check();
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (Component* c : sc) c->dc_pred = 0;
        eobrun_ = 0;
      }
      const int row = static_cast<int>(m / mx), col = static_cast<int>(m % mx);
      if (col == 0) br.check();  // truncated data fails at the row, not after the frame
      if (ns == 1) {
        block(br, *sc[0], row, col, ss, se, ah, al);
      } else {
        for (Component* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              block(br, *c, row * c->v + v, col * c->h + h, ss, se, ah, al);
      }
    }
    br.check();
    pos_ = br.p - d_;
  }

  void block(BitReader& br, Component& c, int brow, int bcol, int ss, int se, int ah, int al) {
    if (!progressive_) return decode_block(br, c, brow, bcol);
    int16_t* blk = c.coef.data() + (static_cast<size_t>(brow) * c.bw + bcol) * 64;
    if (ss == 0) {
      if (ah == 0) {
        dc_first(br, c, blk, al);
      } else if (br.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
    } else if (ah == 0) {
      ac_first(br, c, blk, ss, se, al);
    } else {
      ac_refine(br, c, blk, ss, se, al);
    }
  }

  // jdphuff.c decode_mcu_DC_first, one block.
  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const int s = br.decode(dc_[c.td]);
    if (s > 15) fail("corrupt JPEG: DC magnitude");
    c.dc_pred = add_dc(c.dc_pred, extend(br.get(s), s));
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
  }

  // jdphuff.c decode_mcu_AC_first, one block.
  void ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& tbl = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(tbl);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural.t[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(br.get(sz), sz))
                                                  << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = (1 << r) + static_cast<int>(br.get(r)) - 1;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine, one block: newly nonzero coefficients
  // of magnitude 1 << al, and a correction bit for each one already nonzero.
  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
      const Huffman& tbl = ac_[c.ta];
      for (; k <= se; ++k) {
        const int rs = br.decode(tbl);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a new coefficient's magnitude is always 1
        } else if (r != 15) {
          eobrun_ = (1 << r) + static_cast<int>(br.get(r));
          break;
        }
        do {
          int16_t& coef = blk[kNatural.t[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural.t[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural.t[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
  // progressive frame when one of the first ten coefficients (natural
  // positions below) was never coded to its last bit (Al != 0, or no scan),
  // provided every component's DC arrived and none of those quantizers is 0.
  bool smoothing_wanted() const {
    static constexpr int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps_) {
      for (int pos : kSaved)
        if (c.quant[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // One output row of component c at full width, upsampled as libjpeg-turbo
  // does it with fancy upsampling on (jdsample.c: fullsize; h2v1, h2v2 and
  // h1v2 fancy; h2v1/h2v2 replication when two or fewer samples wide;
  // int_upsample's replication for every other integral ratio).
  void upsample_row(const Component& c, int y, uint8_t* out) const {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const uint8_t* pl = c.plane.data();
    if (rh == 1 && rv == 1) {
      std::memcpy(out, pl + static_cast<size_t>(y) * c.stride, width);
      return;
    }
    const bool fancy = c.dw > 2;
    const int last = c.dw - 1;
    if (rh == 2 && rv == 1) {
      const uint8_t* s = pl + static_cast<size_t>(y) * c.stride;
      for (int x = 0; x < width; ++x) {
        const int j = x >> 1;
        if (!fancy) {
          out[x] = s[j];
        } else if (x & 1) {
          out[x] = static_cast<uint8_t>((3 * s[j] + s[j < last ? j + 1 : last] + 2) >> 2);
        } else {
          out[x] = static_cast<uint8_t>((3 * s[j] + s[j > 0 ? j - 1 : 0] + 1) >> 2);
        }
      }
      return;
    }
    const int iy = y / rv;
    const uint8_t* s0 = pl + static_cast<size_t>(iy) * c.stride;
    // The nearer neighbouring input row (above for an even output row,
    // below for an odd one); past the edges, the edge row itself.
    const int ny = (y & 1) ? (iy + 1 < c.dh ? iy + 1 : c.dh - 1) : (iy > 0 ? iy - 1 : 0);
    const uint8_t* s1 = pl + static_cast<size_t>(ny) * c.stride;
    if (rh == 1 && rv == 2) {  // h1v2 fancy, at any width
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) out[x] = static_cast<uint8_t>((3 * s0[x] + s1[x] + bias) >> 2);
      return;
    }
    if (!(rh == 2 && rv == 2 && fancy)) {  // replication (int_upsample, h2v2_upsample)
      for (int x = 0; x < width; ++x) out[x] = s0[x / rh];
      return;
    }
    auto colsum = [&](int j) { return 3 * s0[j] + s1[j]; };
    for (int x = 0; x < width; ++x) {
      const int j = x >> 1;
      if (x & 1) {
        out[x] = static_cast<uint8_t>((3 * colsum(j) + colsum(j < last ? j + 1 : last) + 7) >> 4);
      } else {
        out[x] = static_cast<uint8_t>((3 * colsum(j) + colsum(j > 0 ? j - 1 : 0) + 8) >> 4);
      }
    }
  }

  // Pillow's MULDIV255 (libImaging/ImagingUtils.h).
  static int muldiv255(int a, int b) {
    const int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
  }

  void convert(uint8_t* out) const {
    const int nc = static_cast<int>(comps_.size());
    std::vector<uint8_t> rows(static_cast<size_t>(nc) * width);
    bool rgb = false;
    if (nc == 3) {
      if (jfif_) {
        rgb = false;
      } else if (adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
      }
    }
    // jdapimin.c: four components are YCCK under an Adobe marker whose
    // transform is not 0, else CMYK.
    const bool ycck = nc == 4 && adobe_ && adobe_transform_ != 0;
    for (int y = 0; y < height; ++y) {
      for (int i = 0; i < nc; ++i) upsample_row(comps_[i], y, rows.data() + i * width);
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      const uint8_t* r0 = rows.data();
      if (nc == 1) {
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        continue;
      }
      const uint8_t* r1 = r0 + width;
      const uint8_t* r2 = r1 + width;
      if (nc == 4) {
        const uint8_t* r3 = r2 + width;
        for (int x = 0; x < width; ++x) {
          int c0 = r0[x], c1 = r1[x], c2 = r2[x];
          if (ycck) {  // jdcolor.c ycck_cmyk_convert: 255 - the YCbCr -> RGB result
            const int yy = c0, cb = c1, cr = c2;
            c0 = 255 - clamp8(yy + kYcc.cr_r[cr]);
            c1 = 255 - clamp8(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            c2 = 255 - clamp8(yy + kYcc.cb_b[cb]);
          }
          // PIL reads libjpeg's CMYK inverted ("CMYK;I"), so its C is
          // 255 - c0 and its K 255 - r3; cmyk2rgb then takes nk = 255 - K.
          const int nk = r3[x];
          o[3 * x] = static_cast<uint8_t>(nk - muldiv255(255 - c0, nk));
          o[3 * x + 1] = static_cast<uint8_t>(nk - muldiv255(255 - c1, nk));
          o[3 * x + 2] = static_cast<uint8_t>(nk - muldiv255(255 - c2, nk));
        }
        continue;
      }
      if (rgb) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp8(yy + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp8(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp8(yy + kYcc.cb_b[cb]);
      }
    }
  }
};

void copy_error(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The frame's size.  Returns 0, or 1 with a message in err.
int kdlt_jpeg_header(const uint8_t* data, int64_t len, int* height, int* width, char* err,
                     int errlen) {
  try {
    JpegDecoder dec(data, len);
    dec.header();
    *height = dec.height;
    *width = dec.width;
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::exception& e) {
    copy_error(std::string("JPEG decode failed: ") + e.what(), err, errlen);
  }
  return 1;
}

// Decode into out (height * width * 3 RGB bytes, the header's size).
// Returns 0, or 1 with a message in err.
int kdlt_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int height, int width,
                     char* err, int errlen) {
  try {
    JpegDecoder dec(data, len);
    dec.header();
    if (dec.height != height || dec.width != width) {
      copy_error("JPEG size changed between header and decode", err, errlen);
      return 1;
    }
    dec.decode(out);
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::exception& e) {
    copy_error(std::string("JPEG decode failed: ") + e.what(), err, errlen);
  }
  return 1;
}

// Undo PNG's per-row filters (None, Sub, Up, Average, Paeth).  src holds
// height rows of 1 + rowbytes bytes (the filter type, then the row); out
// receives height * rowbytes bytes.  bpp: bytes per complete pixel, at
// least 1.  Returns 0, or the 1-based row whose filter type is invalid.
int kdlt_png_unfilter(const uint8_t* src, int height, int64_t rowbytes, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<int64_t>(y) * (rowbytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* o = out + static_cast<int64_t>(y) * rowbytes;
    switch (type) {
      case 0:
        std::memcpy(o, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) o[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0,
                    c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
