// Native WAV codec for matchering_tpu_torch (the JAX package's
// matchering_tpu/io/native/codec.cpp, copied below this header; the writer
// is a template over the sample type, with a float32 entry point,
// mtpu_wav_write_f32, beside the float64 one).
//
// Host-side I/O acceleration: bulk PCM <-> float64 conversion and file
// read/write in C++, exposed through a tiny C ABI consumed via ctypes
// (binding.py).  Plays the role libsndfile plays for the reference
// implementation (matchering/loader.py:35, matchering/saver.py:32).
//
// Build: python -m matchering_tpu_torch.io.native.build

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

constexpr uint16_t kFormatPcm = 0x0001;
constexpr uint16_t kFormatFloat = 0x0003;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct WavInfo {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long long data_offset = 0;
  long long data_bytes = 0;
};

uint32_t ReadU32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t ReadU16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

bool ReadFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out->data(), 1, out->size(), f) : 0;
  std::fclose(f);
  return got == out->size();
}

int ParseWav(const std::vector<uint8_t>& buf, WavInfo* info) {
  if (buf.size() < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    return 1;  // not a WAV
  }
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t size = ReadU32(hdr + 4);
    size_t body = pos + 8;
    if (body > buf.size()) break;
    size_t avail = std::min<size_t>(size, buf.size() - body);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && avail >= 16) {
      const uint8_t* p = buf.data() + body;
      info->tag = ReadU16(p);
      info->channels = ReadU16(p + 2);
      info->sample_rate = ReadU32(p + 4);
      info->bits = ReadU16(p + 14);
      if (info->tag == kFormatExtensible && avail >= 40) {
        info->tag = ReadU16(p + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      info->data_offset = static_cast<long long>(body);
      info->data_bytes = static_cast<long long>(avail);
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  if (!have_fmt || !have_data || info->channels == 0) return 2;
  bool ok = (info->tag == kFormatPcm && (info->bits == 16 || info->bits == 24 || info->bits == 32)) ||
            (info->tag == kFormatFloat && (info->bits == 32 || info->bits == 64));
  return ok ? 0 : 3;
}

void WriteU16(std::vector<uint8_t>* out, uint16_t v) {
  out->push_back(v & 0xFF);
  out->push_back((v >> 8) & 0xFF);
}

void WriteU32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back(v & 0xFF);
  out->push_back((v >> 8) & 0xFF);
  out->push_back((v >> 16) & 0xFF);
  out->push_back((v >> 24) & 0xFF);
}

double ClipRound(double x, double lo, double hi) {
  double r = std::nearbyint(x);
  return r < lo ? lo : (r > hi ? hi : r);
}

// subtype: 0=PCM_16 1=PCM_24 2=PCM_32 3=FLOAT.  A float32 sample is widened
// to double (exact) before it is quantised, so both sample types write the
// same bytes for the same values.
template <typename Sample>
int WriteWav(const char* path, const Sample* data, long long frames,
             int channels, int rate, int subtype) {
  int bits;
  uint16_t tag = kFormatPcm;
  switch (subtype) {
    case 0: bits = 16; break;
    case 1: bits = 24; break;
    case 2: bits = 32; break;
    case 3: bits = 32; tag = kFormatFloat; break;
    default: return 4;
  }
  long long count = frames * channels;
  long long payload_bytes = count * (bits / 8);

  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(payload_bytes) + 64);
  out.insert(out.end(), {'R', 'I', 'F', 'F'});
  WriteU32(&out, 0);  // patched below
  out.insert(out.end(), {'W', 'A', 'V', 'E'});
  out.insert(out.end(), {'f', 'm', 't', ' '});
  WriteU32(&out, 16);
  WriteU16(&out, tag);
  WriteU16(&out, static_cast<uint16_t>(channels));
  WriteU32(&out, static_cast<uint32_t>(rate));
  WriteU32(&out, static_cast<uint32_t>(rate * channels * (bits / 8)));
  WriteU16(&out, static_cast<uint16_t>(channels * (bits / 8)));
  WriteU16(&out, static_cast<uint16_t>(bits));
  if (tag == kFormatFloat) {
    out.insert(out.end(), {'f', 'a', 'c', 't'});
    WriteU32(&out, 4);
    WriteU32(&out, static_cast<uint32_t>(frames));
  }
  out.insert(out.end(), {'d', 'a', 't', 'a'});
  WriteU32(&out, static_cast<uint32_t>(payload_bytes));

  size_t base = out.size();
  out.resize(base + static_cast<size_t>(payload_bytes));
  uint8_t* p = out.data() + base;
  if (subtype == 0) {
    for (long long i = 0; i < count; ++i) {
      int16_t v = static_cast<int16_t>(ClipRound(static_cast<double>(data[i]) * 32768.0, -32768.0, 32767.0));
      std::memcpy(p + 2 * i, &v, 2);
    }
  } else if (subtype == 1) {
    for (long long i = 0; i < count; ++i) {
      int32_t v = static_cast<int32_t>(ClipRound(static_cast<double>(data[i]) * 8388608.0, -8388608.0, 8388607.0));
      p[3 * i] = v & 0xFF;
      p[3 * i + 1] = (v >> 8) & 0xFF;
      p[3 * i + 2] = (v >> 16) & 0xFF;
    }
  } else if (subtype == 2) {
    for (long long i = 0; i < count; ++i) {
      int32_t v = static_cast<int32_t>(ClipRound(static_cast<double>(data[i]) * 2147483648.0, -2147483648.0, 2147483647.0));
      std::memcpy(p + 4 * i, &v, 4);
    }
  } else {
    for (long long i = 0; i < count; ++i) {
      float v = static_cast<float>(data[i]);
      std::memcpy(p + 4 * i, &v, 4);
    }
  }
  if (payload_bytes & 1) out.push_back(0);

  uint32_t riff_size = static_cast<uint32_t>(out.size() - 8);
  out[4] = riff_size & 0xFF;
  out[5] = (riff_size >> 8) & 0xFF;
  out[6] = (riff_size >> 16) & 0xFF;
  out[7] = (riff_size >> 24) & 0xFF;

  FILE* f = std::fopen(path, "wb");
  if (!f) return 10;
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return wrote == out.size() ? 0 : 11;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills frame count, channels and sample rate.
int mtpu_wav_probe(const char* path, long long* frames, int* channels, int* rate) {
  std::vector<uint8_t> buf;
  if (!ReadFile(path, &buf)) return 10;
  WavInfo info;
  int rc = ParseWav(buf, &info);
  if (rc != 0) return rc;
  long long frame_bytes = static_cast<long long>(info.channels) * (info.bits / 8);
  *frames = info.data_bytes / frame_bytes;
  *channels = info.channels;
  *rate = static_cast<int>(info.sample_rate);
  return 0;
}

// Decodes the full data chunk into `out` (interleaved float64, `count` values).
int mtpu_wav_read(const char* path, double* out, long long count) {
  std::vector<uint8_t> buf;
  if (!ReadFile(path, &buf)) return 10;
  WavInfo info;
  int rc = ParseWav(buf, &info);
  if (rc != 0) return rc;
  const uint8_t* p = buf.data() + info.data_offset;
  if (info.tag == kFormatPcm && info.bits == 16) {
    for (long long i = 0; i < count; ++i) {
      int16_t v;
      std::memcpy(&v, p + 2 * i, 2);
      out[i] = static_cast<double>(v) / 32768.0;
    }
  } else if (info.tag == kFormatPcm && info.bits == 24) {
    for (long long i = 0; i < count; ++i) {
      const uint8_t* q = p + 3 * i;
      int32_t v = static_cast<int32_t>(q[0]) | (static_cast<int32_t>(q[1]) << 8) |
                  (static_cast<int32_t>(q[2]) << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = static_cast<double>(v) / 8388608.0;
    }
  } else if (info.tag == kFormatPcm && info.bits == 32) {
    for (long long i = 0; i < count; ++i) {
      int32_t v;
      std::memcpy(&v, p + 4 * i, 4);
      out[i] = static_cast<double>(v) / 2147483648.0;
    }
  } else if (info.tag == kFormatFloat && info.bits == 32) {
    for (long long i = 0; i < count; ++i) {
      float v;
      std::memcpy(&v, p + 4 * i, 4);
      out[i] = static_cast<double>(v);
    }
  } else if (info.tag == kFormatFloat && info.bits == 64) {
    std::memcpy(out, p, static_cast<size_t>(count) * 8);
  } else {
    return 3;
  }
  return 0;
}

// subtype: 0=PCM_16 1=PCM_24 2=PCM_32 3=FLOAT
int mtpu_wav_write(const char* path, const double* data, long long frames,
                   int channels, int rate, int subtype) {
  return WriteWav(path, data, frames, channels, rate, subtype);
}

int mtpu_wav_write_f32(const char* path, const float* data, long long frames,
                       int channels, int rate, int subtype) {
  return WriteWav(path, data, frames, channels, rate, subtype);
}

}  // extern "C"
