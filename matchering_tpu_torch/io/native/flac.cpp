// FLAC codec (subset of RFC 9639) — native backend for matchering_tpu_torch
// (the JAX package's matchering_tpu/io/native/flac.cpp, copied below this
// header; the writer is a template over the sample type, with a float32
// entry point, mtpu_flac_write_f32, beside the float64 one).
//
// The reference gets FLAC through libsndfile (matchering/loader.py:35,
// saver.py:32); this standalone implementation provides:
//   decoder: CONSTANT / VERBATIM / FIXED / LPC subframes, all four channel
//            assignments (independent, left/side, right/side, mid/side),
//            rice + rice2 residual coding incl. escape partitions,
//            wasted bits, arbitrary block sizes.
//   encoder: fixed-predictor (order 0-4, per-subframe best) with single-
//            partition rice coding, independent channels, 16/24-bit PCM,
//            4096-sample frames — valid, reasonably compact FLAC.
//
// Exposed C ABI: mtpu_flac_probe / mtpu_flac_read / mtpu_flac_write /
// mtpu_flac_write_f32.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <string>

namespace {

// ---------------------------------------------------------------------------
// Bit reader

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte_pos >= size; }

  uint32_t read_bit() {
    if (byte_pos >= size) { error = true; return 0; }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((1ull << n) - 1);  // sign extend
    return (int64_t)v;
  }

  uint32_t read_unary() {  // n zero bits then a one bit -> n
    uint32_t n = 0;
    while (!error && read_bit() == 0) ++n;
    return n;
  }

  void align() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }
};

// ---------------------------------------------------------------------------
// Bit writer

struct BitWriter {
  std::vector<uint8_t> out;
  uint8_t cur = 0;
  int bit_pos = 0;

  void write_bit(uint32_t b) {
    cur = (uint8_t)((cur << 1) | (b & 1));
    if (++bit_pos == 8) { out.push_back(cur); cur = 0; bit_pos = 0; }
  }
  void write_bits(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) write_bit((uint32_t)(v >> i) & 1u);
  }
  void write_unary(uint32_t n) {
    for (uint32_t i = 0; i < n; ++i) write_bit(0);
    write_bit(1);
  }
  void align() { while (bit_pos) write_bit(0); }
};

// ---------------------------------------------------------------------------
// CRCs (FLAC: CRC-8 poly 0x07, CRC-16 poly 0x8005, both init 0)

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= d[i];
    for (int b = 0; b < 8; ++b)
      crc = (uint8_t)((crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; ++b)
      crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
  }
  return crc;
}

// ---------------------------------------------------------------------------
// Decoder

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

bool parse_streaminfo(const uint8_t* data, size_t size, StreamInfo* si,
                      size_t* audio_offset) {
  if (size < 4 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  bool have_si = false;
  while (!last && pos + 4 <= size) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    uint8_t type = hdr & 0x7F;
    uint32_t len = ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8) |
                   data[pos + 3];
    pos += 4;
    if (pos + len > size) return false;
    if (type == 0 && len >= 34) {
      const uint8_t* p = data + pos;
      si->sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) | (p[12] >> 4);
      si->channels = ((p[12] >> 1) & 0x7) + 1;
      si->bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si->total_samples = ((uint64_t)(p[13] & 0x0F) << 32) | ((uint64_t)p[14] << 24) |
                          ((uint64_t)p[15] << 16) | ((uint64_t)p[16] << 8) | p[17];
      have_si = true;
    }
    pos += len;
  }
  *audio_offset = pos;
  return have_si && si->sample_rate > 0;
}

// residual for one subframe (into x[order..blocksize))
bool decode_residual(BitReader& br, uint32_t blocksize, uint32_t order,
                     std::vector<int64_t>& resid) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = (uint32_t)br.read_bits(4);
  uint32_t parts = 1u << po;
  if ((blocksize >> po) == 0 || (blocksize % parts) != 0) return false;
  uint32_t idx = order;
  for (uint32_t p = 0; p < parts; ++p) {
    uint32_t count = blocksize >> po;
    if (p == 0) {
      if (count < order) return false;
      count -= order;
    }
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (param == escape) {
      uint32_t bits = (uint32_t)br.read_bits(5);
      for (uint32_t i = 0; i < count; ++i) resid[idx++] = bits ? br.read_signed(bits) : 0;
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t u = ((uint64_t)q << param) | br.read_bits((int)param);
        resid[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // unzigzag
        if (br.error) return false;
      }
    }
  }
  return idx == blocksize && !br.error;
}

bool decode_subframe(BitReader& br, uint32_t blocksize, uint32_t bps,
                     std::vector<int64_t>& x) {
  if (br.read_bit() != 0) return false;  // padding bit
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bit()) wasted = br.read_unary() + 1;
  if (wasted >= bps) return false;
  uint32_t ebps = bps - wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed((int)ebps);
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = br.read_signed((int)ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order = type - 8
    uint32_t order = type - 8;
    for (uint32_t i = 0; i < order; ++i) x[i] = br.read_signed((int)ebps);
    if (!decode_residual(br, blocksize, order, x)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t p = 0;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = x[i - 1]; break;
        case 2: p = 2 * x[i - 1] - x[i - 2]; break;
        case 3: p = 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]; break;
        case 4: p = 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4]; break;
      }
      x[i] += p;
    }
  } else if (type >= 32) {  // LPC, order = (type & 31) + 1
    uint32_t order = (type & 31) + 1;
    for (uint32_t i = 0; i < order; ++i) x[i] = br.read_signed((int)ebps);
    uint32_t prec = (uint32_t)br.read_bits(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (uint32_t i = 0; i < order; ++i) coef[i] = br.read_signed((int)prec);
    if (!decode_residual(br, blocksize, order, x)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (uint32_t j = 0; j < order; ++j) acc += coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted) for (uint32_t i = 0; i < blocksize; ++i) x[i] <<= wasted;
  return !br.error;
}

uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  int extra = 0;
  uint64_t v;
  if (b0 < 0x80) return b0;
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else { br.error = true; return 0; }
  for (int i = 0; i < extra; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

static const uint32_t kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                                         256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const uint32_t kSampleRates[16] = {0, 88200, 176400, 192000, 8000, 16000,
                                          22050, 24000, 32000, 44100, 48000, 96000,
                                          0, 0, 0, 0};
static const uint32_t kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

// Decode the whole stream into interleaved int32 samples.
// Returns frames decoded (samples per channel), or -1 on error.
int64_t decode_stream(const uint8_t* data, size_t size, const StreamInfo& si,
                      size_t pos, int32_t* out, int64_t capacity) {
  int64_t written = 0;
  std::vector<std::vector<int64_t>> ch(si.channels);
  while (pos < size) {
    // find frame sync
    if (pos + 2 > size) break;
    if (!(data[pos] == 0xFF && (data[pos + 1] & 0xFC) == 0xF8)) { ++pos; continue; }
    BitReader br(data + pos, size - pos);
    br.read_bits(14);                      // sync
    br.read_bit();                         // reserved
    br.read_bit();                         // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();                         // reserved
    read_utf8(br);                         // frame or sample number
    uint32_t blocksize = kBlockSizes[bs_code];
    if (bs_code == 6) blocksize = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.read_bits(16) + 1;
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    // header CRC-8
    size_t hdr_len = br.byte_pos + (br.bit_pos ? 1 : 0);
    uint8_t expect8 = (uint8_t)br.read_bits(8);
    if (crc8(data + pos, hdr_len) != expect8) { ++pos; continue; }
    if (blocksize == 0 || br.error) { ++pos; continue; }

    uint32_t nch = ch_code < 8 ? ch_code + 1 : 2;
    if (nch != si.channels) { ++pos; continue; }
    uint32_t bps = ss_code ? kSampleSizes[ss_code] : si.bps;
    if (bps == 0) { ++pos; continue; }

    bool ok = true;
    for (uint32_t c = 0; c < nch && ok; ++c) {
      uint32_t sub_bps = bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      ch[c].assign(blocksize, 0);
      ok = decode_subframe(br, blocksize, sub_bps, ch[c]);
    }
    if (!ok) { ++pos; continue; }
    br.align();
    br.read_bits(16);  // frame CRC-16 (trusted; header CRC already checked)
    if (br.error) { ++pos; continue; }

    // undo stereo decorrelation
    if (ch_code == 8) {        // left/side: R = L - side
      for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) { // right/side: L = side + R
      for (uint32_t i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (ch_code == 10) {// mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (uint32_t i = 0; i < blocksize && written < capacity; ++i, ++written)
      for (uint32_t c = 0; c < nch; ++c)
        out[written * nch + c] = (int32_t)ch[c][i];

    pos += br.byte_pos;
    if (written >= capacity) break;
  }
  return written;
}

// ---------------------------------------------------------------------------
// Encoder (independent channels, fixed predictors, rice partition order 0)

void fixed_residual(const std::vector<int64_t>& x, uint32_t order,
                    std::vector<int64_t>& r) {
  size_t n = x.size();
  r.resize(n);
  for (size_t i = order; i < n; ++i) {
    switch (order) {
      case 0: r[i] = x[i]; break;
      case 1: r[i] = x[i] - x[i - 1]; break;
      case 2: r[i] = x[i] - 2 * x[i - 1] + x[i - 2]; break;
      case 3: r[i] = x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3]; break;
      case 4: r[i] = x[i] - 4 * x[i - 1] + 6 * x[i - 2] - 4 * x[i - 3] + x[i - 4]; break;
    }
  }
}

uint32_t best_rice_param(const std::vector<int64_t>& r, uint32_t order,
                         uint64_t* bits_out) {
  uint64_t sum = 0;
  size_t n = r.size();
  for (size_t i = order; i < n; ++i) {
    int64_t v = r[i];
    sum += (uint64_t)((v << 1) ^ (v >> 63));
  }
  size_t cnt = n - order;
  if (cnt == 0) { *bits_out = 0; return 0; }
  uint32_t best_p = 0;
  uint64_t best_bits = ~0ull;
  for (uint32_t p = 0; p <= 30; ++p) {
    // cost = cnt*(1 + p) + sum >> p (approximate unary quotient total)
    uint64_t bits = (uint64_t)cnt * (1 + p) + (sum >> p);
    if (bits < best_bits) { best_bits = bits; best_p = p; }
  }
  *bits_out = best_bits;
  return best_p;
}

void write_rice(BitWriter& bw, const std::vector<int64_t>& r, uint32_t order,
                uint32_t param) {
  if (param <= 14) {
    bw.write_bits(0, 2);    // rice 4-bit method
    bw.write_bits(0, 4);    // partition order 0
    bw.write_bits(param, 4);
  } else {
    bw.write_bits(1, 2);    // rice2 5-bit method
    bw.write_bits(0, 4);    // partition order 0
    bw.write_bits(param, 5);
  }
  size_t n = r.size();
  for (size_t i = order; i < n; ++i) {
    int64_t v = r[i];
    uint64_t u = (uint64_t)((v << 1) ^ (v >> 63));
    bw.write_unary((uint32_t)(u >> param));
    bw.write_bits(u & ((1ull << param) - 1), (int)param);
  }
}

void utf8_encode(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.write_bits(v, 8); return; }
  int extra;
  uint32_t lead;
  if (v < 0x800) { extra = 1; lead = 0xC0; }
  else if (v < 0x10000) { extra = 2; lead = 0xE0; }
  else if (v < 0x200000) { extra = 3; lead = 0xF0; }
  else if (v < 0x4000000) { extra = 4; lead = 0xF8; }
  else { extra = 5; lead = 0xFC; }
  bw.write_bits(lead | (uint32_t)(v >> (6 * extra)), 8);
  for (int i = extra - 1; i >= 0; --i)
    bw.write_bits(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

std::vector<uint8_t> encode_stream(const int32_t* samples, int64_t frames,
                                   uint32_t channels, uint32_t sample_rate,
                                   uint32_t bps) {
  std::vector<uint8_t> out;
  out.insert(out.end(), {'f', 'L', 'a', 'C'});
  // STREAMINFO (last metadata block)
  uint8_t si[38];
  memset(si, 0, sizeof(si));
  si[0] = 0x80;  // last block, type 0
  si[3] = 34;    // length
  const uint32_t kBlock = 4096;
  uint32_t minb = frames < (int64_t)kBlock ? (uint32_t)frames : kBlock;
  si[4] = (uint8_t)(minb >> 8); si[5] = (uint8_t)minb;
  si[6] = (uint8_t)(kBlock >> 8); si[7] = (uint8_t)kBlock;
  // min/max framesize unknown (0)
  si[14] = (uint8_t)(sample_rate >> 12);
  si[15] = (uint8_t)(sample_rate >> 4);
  si[16] = (uint8_t)(((sample_rate & 0xF) << 4) | ((channels - 1) << 1) |
                     (((bps - 1) >> 4) & 1));
  si[17] = (uint8_t)((((bps - 1) & 0xF) << 4) | (uint8_t)((frames >> 32) & 0xF));
  si[18] = (uint8_t)(frames >> 24);
  si[19] = (uint8_t)(frames >> 16);
  si[20] = (uint8_t)(frames >> 8);
  si[21] = (uint8_t)frames;
  // MD5 left zero (unknown) — allowed by spec
  out.insert(out.end(), si, si + 38);

  std::vector<int64_t> x;
  std::vector<int64_t> resid;
  uint64_t frame_index = 0;
  for (int64_t start = 0; start < frames; start += kBlock, ++frame_index) {
    uint32_t bsz = (uint32_t)((frames - start) < (int64_t)kBlock ? (frames - start)
                                                                 : kBlock);
    BitWriter bw;
    bw.write_bits(0x3FFE, 14);  // sync
    bw.write_bit(0);            // reserved
    bw.write_bit(0);            // fixed blocking
    uint32_t bs_code = (bsz == 4096) ? 12 : 7;  // 4096 or 16-bit at end
    bw.write_bits(bs_code, 4);
    bw.write_bits(0, 4);        // sample rate from STREAMINFO
    bw.write_bits(channels - 1, 4);
    uint32_t ss_code = bps == 16 ? 4 : bps == 24 ? 6 : bps == 8 ? 1 : 4;
    bw.write_bits(ss_code, 3);
    bw.write_bit(0);            // reserved
    utf8_encode(bw, frame_index);
    if (bs_code == 7) bw.write_bits(bsz - 1, 16);
    uint8_t c8 = crc8(bw.out.data(), bw.out.size());  // header is byte aligned here
    bw.write_bits(c8, 8);

    for (uint32_t c = 0; c < channels; ++c) {
      x.assign(bsz, 0);
      for (uint32_t i = 0; i < bsz; ++i) x[i] = samples[(start + i) * channels + c];
      // choose best fixed order
      uint32_t best_order = 0, best_param = 0;
      uint64_t best_bits = ~0ull;
      std::vector<int64_t> best_resid;
      uint32_t max_order = bsz > 4 ? 4 : 0;
      for (uint32_t o = 0; o <= max_order; ++o) {
        fixed_residual(x, o, resid);
        uint64_t bits;
        uint32_t p = best_rice_param(resid, o, &bits);
        bits += (uint64_t)o * bps;
        if (bits < best_bits) {
          best_bits = bits; best_order = o; best_param = p; best_resid = resid;
        }
      }
      bw.write_bit(0);                          // padding
      bw.write_bits(8 + best_order, 6);         // FIXED subframe type
      bw.write_bit(0);                          // no wasted bits
      for (uint32_t i = 0; i < best_order; ++i)
        bw.write_bits((uint64_t)x[i] & ((1ull << bps) - 1), (int)bps);
      write_rice(bw, best_resid, best_order, best_param);
    }
    bw.align();
    uint16_t c16 = crc16(bw.out.data(), bw.out.size());
    bw.write_bits(c16, 16);
    out.insert(out.end(), bw.out.begin(), bw.out.end());
  }
  return out;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path, "rb");
  if (!f) return buf;
  long n = -1;
  if (fseek(f, 0, SEEK_END) == 0) n = ftell(f);
  // a negative ftell would otherwise wrap to ~2^64 in the resize below
  if (n < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return buf;
  }
  buf.resize((size_t)n);
  if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) buf.clear();
  fclose(f);
  return buf;
}

// float64 or float32 interleaved [-1, 1) -> `bps`-bit codes (16 or 24).  A
// float32 sample is widened to double (exact) before it is quantised, so
// both sample types give the same codes for the same values.
template <typename Sample>
std::vector<int32_t> quantise(const Sample* samples, long long count, int bps) {
  double scale = (double)(1ll << (bps - 1));
  double lo = -scale, hi = scale - 1.0;
  std::vector<int32_t> pcm((size_t)count);
  for (long long i = 0; i < count; ++i) {
    double v = (double)samples[i] * scale;
    if (v > hi) v = hi;
    if (v < lo) v = lo;
    pcm[i] = (int32_t)llrint(v);
  }
  return pcm;
}

// Encodes the codes and writes the file. Returns 0 on success.
int write_codes(const char* path, const std::vector<int32_t>& pcm, long long frames,
                int channels, int sample_rate, int bps) {
  std::vector<uint8_t> out = encode_stream(pcm.data(), frames, (uint32_t)channels,
                                           (uint32_t)sample_rate, (uint32_t)bps);
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  size_t w = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return w == out.size() ? 0 : -3;
}

}  // namespace

extern "C" {

// Probe: fills frames/channels/sample_rate/bps. Returns 0 on success.
int mtpu_flac_probe(const char* path, long long* frames, int* channels,
                    int* sample_rate, int* bps) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -1;
  StreamInfo si;
  size_t audio;
  if (!parse_streaminfo(buf.data(), buf.size(), &si, &audio)) return -2;
  *frames = (long long)si.total_samples;
  *channels = (int)si.channels;
  *sample_rate = (int)si.sample_rate;
  *bps = (int)si.bps;
  return 0;
}

// Read: decodes into caller-provided interleaved float64 buffer scaled to
// [-1, 1). Returns frames decoded, or negative on error.
long long mtpu_flac_read(const char* path, double* out, long long capacity) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -1;
  StreamInfo si;
  size_t audio;
  if (!parse_streaminfo(buf.data(), buf.size(), &si, &audio)) return -2;
  std::vector<int32_t> pcm((size_t)capacity * si.channels);
  int64_t n = decode_stream(buf.data(), buf.size(), si, audio, pcm.data(), capacity);
  if (n < 0) return -3;
  double scale = 1.0 / (double)(1ll << (si.bps - 1));
  for (int64_t i = 0; i < n * (int64_t)si.channels; ++i) out[i] = pcm[i] * scale;
  return n;
}

// Write: float64 interleaved [-1, 1) -> FLAC with `bps` (16 or 24).
// Returns 0 on success.
int mtpu_flac_write(const char* path, const double* samples, long long frames,
                    int channels, int sample_rate, int bps) {
  if (bps != 16 && bps != 24) return -1;
  return write_codes(path, quantise(samples, frames * channels, bps), frames, channels,
                     sample_rate, bps);
}

// The same from float32 samples.
int mtpu_flac_write_f32(const char* path, const float* samples, long long frames,
                        int channels, int sample_rate, int bps) {
  if (bps != 16 && bps != 24) return -1;
  return write_codes(path, quantise(samples, frames * channels, bps), frames, channels,
                     sample_rate, bps);
}

}  // extern "C"
