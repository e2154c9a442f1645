// Host audio decode for the port's data and serving paths, without libav.
//
// The counterpart of mico_tpu/csrc/audio_decode.cpp with the same C ABI:
// a file -> channel 0 -> float32 mono at the target sample rate (Kaldi and
// torchaudio read channel 0, not a downmix). Where the JAX package hands
// every container to libavformat, libavcodec and libswresample, this file
// reads the two containers the corpus and the demos use by hand:
//
//   - RIFF/WAVE: PCM u8, s16, s24, s32, IEEE float 32 and 64, plain or
//     WAVE_FORMAT_EXTENSIBLE, any channel count;
//   - FLAC: every subframe type, channel assignment and residual coding
//     of the format, bit depths 4-24, CRC-8 and CRC-16 checked.
//
// Samples become floats exactly as libav's decoders and the JAX file's
// `append_channel0` make them (s16 / 32768, s32 / 2^31, (u8 - 128) / 128,
// f32 as is, f64 rounded), and the resampler is libswresample 4's default
// float path, rebuilt: Kaiser-windowed sinc (beta 9), 32 taps at unit
// factor, cutoff 0.97, 1024 phases unless the reduced ratio needs fewer,
// linear interpolation between phases, no start delay, a reflected start
// and a reflected flush. Any other container (MP3, AAC/MP4, Ogg, ...) is
// refused with what was found; a damaged FLAC frame is an error, never a
// partial signal. Errors are described by mico_audio_error().

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <new>
#include <vector>

namespace {

thread_local std::string g_error;

enum : int {
  kOk = 0,
  kOpen = -1,         // the file cannot be read
  kUnsupported = -2,  // a container or codec this decoder does not read
  kCorrupt = -3,      // a malformed, damaged or truncated stream
  kNoMemory = -6,
};

struct Failure {
  int code;
};

[[noreturn]] void fail(int code, const std::string& what) {
  g_error = what;
  throw Failure{code};
}

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

std::string hex_bytes(const uint8_t* p, size_t n) {
  std::string s;
  char b[4];
  for (size_t i = 0; i < n; i++) {
    snprintf(b, sizeof b, i ? " %02x" : "%02x", p[i]);
    s += b;
  }
  return s;
}

// ---------------------------------------------------------------------------
// RIFF/WAVE
// ---------------------------------------------------------------------------

enum class Pcm { kU8, kS16, kS24, kS32, kF32, kF64 };

void decode_wav(const std::vector<uint8_t>& f, std::vector<float>* out,
                int* rate) {
  const size_t size = f.size();
  size_t pos = 12;
  bool have_fmt = false;
  Pcm kind = Pcm::kS16;
  int channels = 0, width = 0;
  while (pos + 8 <= size) {
    const uint8_t* h = f.data() + pos;
    uint32_t len = le32(h + 4);
    pos += 8;
    if (!memcmp(h, "fmt ", 4)) {
      if (len < 16 || pos + 16 > size) fail(kCorrupt, "WAV: short fmt chunk");
      const uint8_t* c = f.data() + pos;
      uint32_t tag = le16(c);
      channels = le16(c + 2);
      *rate = static_cast<int>(le32(c + 4));
      int bits = le16(c + 14);
      if (tag == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE: the GUID's first word
        if (len < 40 || pos + 40 > size)
          fail(kCorrupt, "WAV: short WAVE_FORMAT_EXTENSIBLE fmt chunk");
        tag = le16(c + 24);
      }
      if (channels < 1 || *rate < 1 || bits < 1)
        fail(kCorrupt, "WAV: fmt chunk with " + std::to_string(channels) +
                           " channels, " + std::to_string(*rate) + " Hz, " +
                           std::to_string(bits) + " bits");
      width = (bits + 7) / 8;
      if (tag == 1) {
        if (width > 4) fail(kUnsupported, "WAV: " + std::to_string(bits) +
                                              "-bit integer PCM");
        kind = width == 1 ? Pcm::kU8 : width == 2 ? Pcm::kS16
                                     : width == 3 ? Pcm::kS24 : Pcm::kS32;
      } else if (tag == 3) {
        if (width != 4 && width != 8)
          fail(kUnsupported, "WAV: " + std::to_string(bits) + "-bit float");
        kind = width == 4 ? Pcm::kF32 : Pcm::kF64;
      } else {
        char t[8];
        snprintf(t, sizeof t, "0x%04x", tag);
        fail(kUnsupported, std::string("WAV with codec tag ") + t +
                               " (not integer PCM or IEEE float)");
      }
      have_fmt = true;
    } else if (!memcmp(h, "data", 4)) {
      if (!have_fmt) fail(kCorrupt, "WAV: data chunk before fmt chunk");
      size_t avail = size - pos;
      // 0 and 0xFFFFFFFF mean a stream whose length was not known: to EOF
      size_t bytes = (len == 0 || len == 0xFFFFFFFFu) ? avail
                                                      : std::min<size_t>(len, avail);
      const size_t frame = size_t(channels) * width;
      const size_t n = bytes / frame;
      out->resize(n);
      const uint8_t* p = f.data() + pos;
      float* o = out->data();
      for (size_t i = 0; i < n; i++, p += frame) {
        switch (kind) {
          case Pcm::kU8: o[i] = (p[0] - 128) / 128.0f; break;
          case Pcm::kS16:
            o[i] = static_cast<int16_t>(le16(p)) / 32768.0f;
            break;
          case Pcm::kS24:  // libav widens s24 to s32 by << 8
            o[i] = static_cast<int32_t>((uint32_t(p[0]) << 8) |
                                        (uint32_t(p[1]) << 16) |
                                        (uint32_t(p[2]) << 24)) /
                   2147483648.0f;
            break;
          case Pcm::kS32:
            o[i] = static_cast<int32_t>(le32(p)) / 2147483648.0f;
            break;
          case Pcm::kF32: {
            uint32_t u = le32(p);
            float v;
            memcpy(&v, &u, 4);
            o[i] = v;
            break;
          }
          case Pcm::kF64: {
            uint64_t u = le32(p) | (uint64_t(le32(p + 4)) << 32);
            double v;
            memcpy(&v, &u, 8);
            o[i] = static_cast<float>(v);
            break;
          }
        }
      }
      return;
    }
    if (len > size - pos) break;
    pos += len + (len & 1);  // chunks are padded to even sizes
  }
  fail(kCorrupt, have_fmt ? "WAV: no data chunk" : "WAV: no fmt chunk");
}

// ---------------------------------------------------------------------------
// FLAC
// ---------------------------------------------------------------------------

uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= p[i];
    for (int b = 0; b < 8; b++) c = (c & 0x80) ? uint8_t(c << 1) ^ 0x07 : uint8_t(c << 1);
  }
  return c;
}

struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int i = 0; i < 256; i++) {
      uint16_t c = uint16_t(i << 8);
      for (int b = 0; b < 8; b++) c = (c & 0x8000) ? uint16_t(c << 1) ^ 0x8005 : uint16_t(c << 1);
      t[i] = c;
    }
  }
};

uint16_t crc16(const uint8_t* p, size_t n) {
  static const Crc16Table table;
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++) c = uint16_t(c << 8) ^ table.t[(c >> 8) ^ p[i]];
  return c;
}

// MSB-first bit reader over [p, end) with a 64-bit cache; reading past the
// end is a truncated frame.
class Bits {
 public:
  Bits(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  uint32_t get(int n) {  // n <= 32
    if (n == 0) return 0;
    if (avail_ < n) {
      refill();
      if (avail_ < n) truncated();
    }
    const uint32_t v = uint32_t(cache_ >> (64 - n));
    cache_ <<= n;
    avail_ -= n;
    return v;
  }
  int32_t get_signed(int n) {
    if (n == 0) return 0;
    const uint32_t v = get(n);
    return n == 32 ? int32_t(v) : int32_t(v << (32 - n)) >> (32 - n);
  }
  uint32_t bit() { return get(1); }
  uint64_t unary() {  // zeros before the next one
    uint64_t n = 0;
    for (;;) {
      if (avail_ == 0) {
        refill();
        if (avail_ == 0) truncated();
      }
      if (cache_) {  // bits below `avail_` are zero, so the one is in range
        const int z = __builtin_clzll(cache_);
        n += z;
        cache_ <<= z;
        cache_ <<= 1;
        avail_ -= z + 1;
        return n;
      }
      n += avail_;
      avail_ = 0;
    }
  }
  void align() {
    const int d = avail_ & 7;
    cache_ <<= d;
    avail_ -= d;
  }
  const uint8_t* pos() const { return p_ - avail_ / 8; }  // when aligned
  [[noreturn]] static void truncated() { fail(kCorrupt, "FLAC: truncated frame"); }

 private:
  void refill() {
    while (avail_ <= 56 && p_ < end_) {
      cache_ |= uint64_t(*p_++) << (56 - avail_);
      avail_ += 8;
    }
  }
  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t cache_ = 0;
  int avail_ = 0;
};

struct StreamInfo {
  int rate = 0, channels = 0, bps = 0;
  uint64_t total = 0;
};

void residual(Bits& b, int block, int order, int64_t* s) {
  const uint32_t method = b.get(2);
  if (method > 1) fail(kCorrupt, "FLAC: reserved residual coding method");
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 15 : 31;
  const int porder = int(b.get(4));
  const int parts = 1 << porder;
  if ((block >> porder) << porder != block || (block >> porder) < order)
    fail(kCorrupt, "FLAC: bad residual partition order");
  int i = order;
  for (int part = 0; part < parts; part++) {
    const int end = (part + 1) * (block >> porder);
    const uint32_t k = b.get(pbits);
    if (k == escape) {
      const int raw = int(b.get(5));
      for (; i < end; i++) s[i] = b.get_signed(raw);
    } else {
      for (; i < end; i++) {
        const uint64_t u = (b.unary() << k) | b.get(int(k));
        s[i] = int64_t(u >> 1) ^ -int64_t(u & 1);
      }
    }
  }
}

void subframe(Bits& b, int block, int bps, int64_t* s) {
  if (b.bit()) fail(kCorrupt, "FLAC: subframe padding bit set");
  const uint32_t type = b.get(6);
  int wasted = 0;
  if (b.bit()) wasted = int(b.unary()) + 1;
  if (wasted >= bps) fail(kCorrupt, "FLAC: wasted bits exceed the depth");
  bps -= wasted;
  if (type == 0) {  // CONSTANT
    const int64_t v = b.get_signed(bps);
    for (int i = 0; i < block; i++) s[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block; i++) s[i] = b.get_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    const int order = int(type - 8);
    if (order > block) fail(kCorrupt, "FLAC: predictor order exceeds block");
    for (int i = 0; i < order; i++) s[i] = b.get_signed(bps);
    residual(b, block, order, s);
    for (int i = order; i < block; i++) {
      switch (order) {
        case 1: s[i] += s[i - 1]; break;
        case 2: s[i] += 2 * s[i - 1] - s[i - 2]; break;
        case 3: s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
        case 4:
          s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
          break;
      }
    }
  } else if (type >= 32) {  // LPC
    const int order = int(type - 31);
    if (order > block) fail(kCorrupt, "FLAC: predictor order exceeds block");
    for (int i = 0; i < order; i++) s[i] = b.get_signed(bps);
    const int precision = int(b.get(4)) + 1;
    if (precision == 16) fail(kCorrupt, "FLAC: invalid LPC precision");
    const int shift = b.get_signed(5);
    if (shift < 0) fail(kCorrupt, "FLAC: negative LPC shift");
    int64_t coef[32];
    for (int j = 0; j < order; j++) coef[j] = b.get_signed(precision);
    residual(b, block, order, s);
    for (int i = order; i < block; i++) {
      int64_t sum = 0;
      for (int j = 0; j < order; j++) sum += coef[j] * s[i - 1 - j];
      s[i] += sum >> shift;
    }
  } else {
    fail(kCorrupt, "FLAC: reserved subframe type " + std::to_string(type));
  }
  if (wasted)
    for (int i = 0; i < block; i++) s[i] = int64_t(uint64_t(s[i]) << wasted);
}

const int kRates[12] = {0,     88200, 176400, 192000, 8000,  16000,
                        22050, 24000, 32000,  44100,  48000, 96000};
const int kDepths[8] = {0, 8, 12, -1, 16, 20, 24, 32};

// Decodes the frame at p; appends channel 0 as float; returns its end.
const uint8_t* flac_frame(const uint8_t* p, const uint8_t* end,
                          const StreamInfo& si, std::vector<int64_t>* work,
                          std::vector<float>* out) {
  const uint8_t* start = p;
  Bits b(p, end);
  if (b.get(15) != 0x7FFC) fail(kCorrupt, "FLAC: lost frame sync");
  b.get(1);  // blocking strategy: fixed or variable sizes, read alike
  const uint32_t bs_code = b.get(4), sr_code = b.get(4);
  const uint32_t assign = b.get(4), depth_code = b.get(3);
  if (b.bit()) fail(kCorrupt, "FLAC: reserved frame header bit set");
  // the frame or sample number, UTF-8 coded in 1 to 7 bytes
  uint32_t lead = b.get(8);
  int more = 0;
  if (lead >= 0x80) {
    if (lead == 0xFE) more = 6;
    else if ((lead & 0xFE) == 0xFC) more = 5;
    else if ((lead & 0xFC) == 0xF8) more = 4;
    else if ((lead & 0xF8) == 0xF0) more = 3;
    else if ((lead & 0xF0) == 0xE0) more = 2;
    else if ((lead & 0xE0) == 0xC0) more = 1;
    else fail(kCorrupt, "FLAC: bad frame number coding");
  }
  for (int i = 0; i < more; i++)
    if ((b.get(8) & 0xC0) != 0x80) fail(kCorrupt, "FLAC: bad frame number coding");
  int block;
  if (bs_code == 0) fail(kCorrupt, "FLAC: reserved block size code");
  else if (bs_code == 1) block = 192;
  else if (bs_code <= 5) block = 576 << (bs_code - 2);
  else if (bs_code == 6) block = int(b.get(8)) + 1;
  else if (bs_code == 7) block = int(b.get(16)) + 1;
  else block = 256 << (bs_code - 8);
  if (sr_code == 12) b.get(8);  // kHz
  else if (sr_code == 13 || sr_code == 14) b.get(16);  // Hz, tens of Hz
  else if (sr_code == 15) fail(kCorrupt, "FLAC: invalid sample rate code");
  const uint32_t crc = b.get(8);
  if (crc8(start, size_t(b.pos() - start) - 1) != crc)
    fail(kCorrupt, "FLAC: frame header CRC-8 mismatch");
  int bps = kDepths[depth_code];
  if (depth_code == 0) bps = si.bps;
  if (bps != si.bps)
    fail(kUnsupported, "FLAC: the bit depth changes within the stream");
  int channels;
  if (assign < 8) channels = int(assign) + 1;
  else if (assign <= 10) channels = 2;
  else fail(kCorrupt, "FLAC: reserved channel assignment");
  if (channels != si.channels)
    fail(kUnsupported, "FLAC: the channel count changes within the stream");
  work->resize(size_t(2) * block);
  int64_t* ch0 = work->data();
  int64_t* ch1 = ch0 + block;
  // the side channel carries one bit more
  const int side = assign == 8 ? 1 : assign == 9 ? 0 : assign == 10 ? 1 : -1;
  std::vector<int64_t> skip;
  for (int c = 0; c < channels; c++) {
    int64_t* s = c == 0 ? ch0 : c == 1 ? ch1 : nullptr;
    if (!s) {  // channels past the second are decoded and dropped
      skip.resize(block);
      s = skip.data();
    }
    subframe(b, block, bps + (c == side ? 1 : 0), s);
  }
  b.align();
  const uint8_t* crc_at = b.pos();
  if (end - crc_at < 2) Bits::truncated();
  if (crc16(start, size_t(crc_at - start)) != ((crc_at[0] << 8) | crc_at[1]))
    fail(kCorrupt, "FLAC: frame CRC-16 mismatch");
  if (assign == 8) {  // left, side: left is channel 0 as stored
  } else if (assign == 9) {  // side, right: left = side + right
    for (int i = 0; i < block; i++) ch0[i] += ch1[i];
  } else if (assign == 10) {  // mid, side
    for (int i = 0; i < block; i++) {
      int64_t mid = int64_t(uint64_t(ch0[i]) << 1) | (ch1[i] & 1);
      ch0[i] = (mid + ch1[i]) >> 1;
    }
  }
  const float scale = std::ldexp(1.0f, 1 - bps);  // exact: |s| < 2^24
  const size_t at = out->size();
  out->resize(at + size_t(block));
  for (int i = 0; i < block; i++) (*out)[at + i] = float(ch0[i]) * scale;
  return crc_at + 2;
}

void decode_flac(const std::vector<uint8_t>& f, size_t pos,
                 std::vector<float>* out, int* rate) {
  const uint8_t* p = f.data() + pos + 4;
  const uint8_t* end = f.data() + f.size();
  StreamInfo si;
  bool have_info = false, last = false;
  while (!last) {
    if (end - p < 4) fail(kCorrupt, "FLAC: truncated metadata");
    last = p[0] & 0x80;
    const int type = p[0] & 0x7F;
    const uint32_t len = (p[1] << 16) | (p[2] << 8) | p[3];
    p += 4;
    if (uint32_t(end - p) < len) fail(kCorrupt, "FLAC: truncated metadata");
    if (type == 0) {
      if (len < 34) fail(kCorrupt, "FLAC: short STREAMINFO");
      si.rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 7) + 1;
      si.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total = (uint64_t(p[13] & 0x0F) << 32) | (uint64_t(p[14]) << 24) |
                 (p[15] << 16) | (p[16] << 8) | p[17];
      have_info = true;
    } else if (type == 127) {
      fail(kCorrupt, "FLAC: invalid metadata block type");
    }
    p += len;  // PADDING, SEEKTABLE, VORBIS_COMMENT, ... are skipped
  }
  if (!have_info) fail(kCorrupt, "FLAC: no STREAMINFO");
  if (si.rate < 1) fail(kCorrupt, "FLAC: sample rate 0 in STREAMINFO");
  if (si.bps < 4 || si.bps > 24)
    fail(kUnsupported, "FLAC: " + std::to_string(si.bps) +
                           "-bit samples (4 to 24 are read)");
  *rate = si.rate;
  if (si.total) out->reserve(size_t(si.total));
  std::vector<int64_t> work;
  while (p < end) {
    if (end - p >= 2 && p[0] == 0xFF && (p[1] & 0xFE) == 0xF8) {
      p = flac_frame(p, end, si, &work, out);
    } else if (si.total && out->size() >= si.total) {
      break;  // trailing bytes after the last frame (an ID3v1 tag, ...)
    } else {
      fail(kCorrupt, "FLAC: no frame sync at byte " +
                         std::to_string(p - f.data()));
    }
  }
  if (si.total && out->size() != si.total)
    fail(kCorrupt, "FLAC: " + std::to_string(out->size()) + " of " +
                       std::to_string(si.total) +
                       " samples in the stream (truncated)");
}

// ---------------------------------------------------------------------------
// The container by its magic
// ---------------------------------------------------------------------------

std::string unsupported_name(const uint8_t* p, size_t n) {
  auto is = [&](size_t at, const char* m) {
    size_t k = strlen(m);
    return n >= at + k && !memcmp(p + at, m, k);
  };
  if (is(0, "ID3")) return "MP3 (an ID3v2 tag before MPEG audio)";
  if (is(0, "OggS")) return "Ogg (Vorbis, Opus or FLAC in Ogg)";
  if (is(4, "ftyp"))
    return "MP4/M4A (ISO BMFF, brand '" + std::string(p + 8, p + std::min<size_t>(n, 12)) +
           "'; AAC or other codecs)";
  if (is(0, "RF64") || is(0, "BW64")) return "RF64/BW64 WAV";
  if (is(0, "FORM")) return "AIFF (IFF FORM)";
  if (is(0, "caff")) return "Core Audio Format";
  if (is(0, "\x1a\x45\xdf\xa3")) return "Matroska/WebM";
  if (is(0, "#!AMR")) return "AMR";
  if (is(0, "MAC ")) return "Monkey's Audio";
  if (is(0, "wvpk")) return "WavPack";
  if (n >= 2 && p[0] == 0xFF && (p[1] & 0xF6) == 0xF0)
    return "AAC (ADTS frame sync)";
  if (n >= 2 && p[0] == 0xFF && (p[1] & 0xE0) == 0xE0)
    return "MP3 (MPEG audio frame sync)";
  return "unknown container, first bytes " + hex_bytes(p, std::min<size_t>(n, 8));
}

void decode_file(const char* path, std::vector<float>* out, int* rate) {
  FILE* fp = fopen(path, "rb");
  if (!fp) fail(kOpen, std::string("cannot open: ") + strerror(errno));
  std::vector<uint8_t> f;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, fp)) > 0) f.insert(f.end(), buf, buf + got);
  const bool bad = ferror(fp);
  fclose(fp);
  if (bad) fail(kOpen, "read error");
  const uint8_t* p = f.data();
  const size_t n = f.size();
  if (n >= 12 && !memcmp(p, "RIFF", 4) && !memcmp(p + 8, "WAVE", 4)) {
    decode_wav(f, out, rate);
    return;
  }
  size_t pos = 0;
  if (n >= 10 && !memcmp(p, "ID3", 3)) {  // an ID3v2 tag may precede fLaC
    pos = 10 + ((p[6] & 0x7F) << 21 | (p[7] & 0x7F) << 14 |
                (p[8] & 0x7F) << 7 | (p[9] & 0x7F));
    if (p[5] & 0x10) pos += 10;  // footer
  }
  if (n >= pos + 4 && !memcmp(p + pos, "fLaC", 4)) {
    decode_flac(f, pos, out, rate);
    return;
  }
  if (n == 0) fail(kCorrupt, "empty file");
  fail(kUnsupported, unsupported_name(p, n));
}

// ---------------------------------------------------------------------------
// Resampling: libswresample 4's default float path
// ---------------------------------------------------------------------------

// I0 by its power series (|x| <= 9 here, so it converges to double
// precision in a few dozen terms).
double bessel_i0(double x) {
  const double h = x * x / 4.0;
  double t = 1.0, s = 1.0;
  for (int k = 1;; k++) {
    t = t * h / (double(k) * k);
    const double next = s + t;
    if (next == s) return next;
    s = next;
  }
}

struct Plan {
  int taps, phases, alloc;  // filter length, phase count, row stride
  int64_t src_incr, dst_incr;
  std::vector<float> bank;  // (phases + 1) rows of `alloc`
};

Plan make_plan(int src, int dst) {
  const double cutoff = 0.97, beta = 9.0;
  const int filter_size = 32, phase_shift = 10;
  Plan pl;
  const double factor = std::min(dst * cutoff / src, 1.0);
  int phases = 1 << phase_shift;
  int taps = std::max(int(std::ceil(filter_size / factor)), 1);
  if (taps > 1) taps = (taps + 1) & ~1;
  const int g = std::gcd(src, dst);
  if (dst / g <= phases) phases = dst / g;  // exact_rational
  pl.taps = taps;
  pl.phases = phases;
  pl.alloc = (taps + 7) & ~7;
  const int alloc = pl.alloc, center = (taps - 1) / 2;
  pl.bank.assign(size_t(alloc) * (phases + 1), 0.0f);
  float* bank = pl.bank.data();
  // build_filter: rows 0 .. phases/2 by formula, the rest mirrored
  const int ph_nb = phases % 2 ? phases : phases / 2 + 1;
  std::vector<double> tab(taps);
  double norm = 0;
  for (int ph = 0; ph < ph_nb; ph++) {
    double s = factor == 1.0 ? std::sin(M_PI * ph / phases) * (center & 1 ? 1 : -1)
                             : 0.0;
    for (int i = 0; i < taps; i++) {
      const double x = M_PI * (double(i - center) - double(ph) / phases) * factor;
      double y = x == 0 ? 1.0 : factor == 1.0 ? s / x : std::sin(x) / x;
      const double w = 2.0 * x / (factor * taps * M_PI);
      y *= bessel_i0(beta * std::sqrt(std::max(1 - w * w, 0.0)));
      tab[i] = y;
      s = -s;
      if (!ph) norm += y;
    }
    for (int i = 0; i < taps; i++) bank[ph * alloc + i] = float(tab[i] * 1 / norm);
    if (phases % 2) continue;
    for (int i = 0; i < taps; i++)  // in place where phases - ph == ph
      bank[(phases - ph) * alloc + taps - 1 - i] = bank[ph * alloc + i];
  }
  // row `phases` is row 0 one sample later
  memmove(bank + size_t(alloc) * phases + 1, bank, (alloc - 1) * sizeof(float));
  bank[size_t(alloc) * phases] = bank[alloc - 1];
  // the output step in phase units, as src_incr / dst_incr
  const int64_t a = dst, b = int64_t(src) * phases, gg = std::gcd(a, b);
  pl.src_incr = a / gg;
  pl.dst_incr = b / gg;
  while (pl.dst_incr < (1 << 20) && pl.src_incr < (1 << 20)) {
    pl.dst_incr *= 2;
    pl.src_incr *= 2;
  }
  return pl;
}

// Every output k sits at k * dst_incr / src_incr phase units; its window
// starts `center` samples before sample floor(that / phases).
struct Step {
  int64_t start, frac;
  int phase;
};

Step step_at(const Plan& pl, int64_t k, int center) {
  const int64_t tot = k * pl.dst_incr;
  const int64_t ph = tot / pl.src_incr;
  return {ph / pl.phases - center, tot % pl.src_incr, int(ph % pl.phases)};
}

std::vector<float> resample(const float* x, int64_t n, int src, int dst) {
  if (src == dst || n == 0) return std::vector<float>(x, x + n);
  const Plan pl = make_plan(src, dst);
  const int L = pl.taps, center = (L - 1) / 2;
  // The stream swr_convert and its flush see: the input reflected about its
  // first sample, then the input, then `r` samples reflected about its end
  // (the last sample repeated first). Inputs of at most L samples wait in
  // the library's buffer until the flush, which extends them first.
  int64_t last;  // the last stream sample an output window may reach
  int64_t r;
  if (n <= L) {
    r = (n + 1) / 2;
    if (n + r < L + 1) return {};
    last = n - 1 + r;
  } else {
    // outputs whose window ends inside the input come first; the flush
    // reflects half of what is left in the buffer after them
    int64_t lo = 0, hi = (n + L) * int64_t(dst) / src + 2;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (step_at(pl, mid, center).start + L - 1 > n - 1) hi = mid;
      else lo = mid + 1;
    }
    const int64_t left = n - step_at(pl, lo, center).start;
    r = (std::min<int64_t>(left, L) + 1) / 2;
    last = n - 1 + r;
  }
  // V[L + i] is stream sample i; one more reflected sample and zeros past
  // `last` feed the taps the library's vector loops read past L
  const int64_t ext = last + 1;  // stream samples 0 .. last
  std::vector<float> V(size_t(L + ext + 1 + pl.alloc), 0.0f);
  float* v = V.data() + L;
  for (int64_t i = 0; i < n; i++) v[i] = x[i];
  for (int64_t j = 0; j <= r && n - 1 - j >= 0; j++) v[n + j] = x[n - 1 - j];
  for (int m = 1; m <= L; m++) v[-m] = v[m];
  std::vector<float> out;
  out.reserve(size_t(ext * int64_t(dst) / src + 2));
  const bool linear = pl.dst_incr % pl.src_incr != 0;
  const double inv = 1.0 / double(pl.src_incr);
  for (int64_t k = 0;; k++) {
    const Step st = step_at(pl, k, center);
    if (st.start + L - 1 > last) break;
    const float* w = v + st.start;
    const float* f = pl.bank.data() + size_t(pl.alloc) * st.phase;
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < pl.alloc; i++) acc[i & 7] += w[i] * f[i];
    float val = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
                ((acc[2] + acc[6]) + (acc[3] + acc[7]));
    if (linear) {
      const float* f2 = f + pl.alloc;
      float acc2[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int i = 0; i < pl.alloc; i++) acc2[i & 7] += w[i] * f2[i];
      const float v2 = ((acc2[0] + acc2[4]) + (acc2[1] + acc2[5])) +
                       ((acc2[2] + acc2[6]) + (acc2[3] + acc2[7]));
      val = float(val + double(v2 - val) * inv * double(st.frac));
    }
    out.push_back(val);
  }
  return out;
}

int finish(std::vector<float>&& v, float** out_data, int64_t* out_n) {
  float* buf = static_cast<float*>(malloc(std::max<size_t>(v.size(), 1) * sizeof(float)));
  if (!buf) {
    g_error = "out of memory";
    return kNoMemory;
  }
  if (!v.empty()) memcpy(buf, v.data(), v.size() * sizeof(float));
  *out_data = buf;
  *out_n = int64_t(v.size());
  return kOk;
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees *out_data with mico_free(). target_sr
// <= 0 keeps the file's own rate.
int mico_decode_audio(const char* path, int target_sr, float** out_data,
                      int64_t* out_n, int* out_src_sr) {
  *out_data = nullptr;
  *out_n = 0;
  *out_src_sr = 0;
  try {
    std::vector<float> samples;
    int rate = 0;
    decode_file(path, &samples, &rate);
    *out_src_sr = rate;
    if (target_sr > 0)
      samples = resample(samples.data(), int64_t(samples.size()), rate, target_sr);
    return finish(std::move(samples), out_data, out_n);
  } catch (const Failure& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return kNoMemory;
  }
}

// The resampler alone: n float32 samples at src_sr -> *out_n at dst_sr.
int mico_resample(const float* in, int64_t n, int src_sr, int dst_sr,
                  float** out_data, int64_t* out_n) {
  *out_data = nullptr;
  *out_n = 0;
  if (src_sr < 1 || dst_sr < 1) {
    g_error = "sample rates must be positive";
    return kCorrupt;
  }
  try {
    return finish(resample(in, n, src_sr, dst_sr), out_data, out_n);
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return kNoMemory;
  }
}

// The calling thread's last error.
const char* mico_audio_error() { return g_error.c_str(); }

void mico_free(float* p) { free(p); }

}  // extern "C"
