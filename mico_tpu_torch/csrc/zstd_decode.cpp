// Zstandard decoding (RFC 8878) on the host, for the port's .orbax reader.
//
// An .orbax checkpoint keeps its b-tree nodes and its zarr chunks as zstd
// frames (mico_tpu_torch/train/ocdbt.py, orbax_format.py). Neither machine
// may give the port a zstd library, so this file decodes the format by
// hand:
//
//   - frames: single-segment or windowed headers, with or without the
//     content size, the XXH64 content checksum, skippable frames, and any
//     number of frames one after another (their outputs concatenated);
//   - blocks: Raw, RLE and Compressed;
//   - literals: raw, RLE, Huffman-coded with 1 or 4 streams, and treeless
//     (the previous block's Huffman table), the tree given by FSE-coded or
//     direct 4-bit weights;
//   - sequences: predefined, RLE, FSE-coded and repeated tables for literal
//     lengths, offsets and match lengths, and the three repeat offsets.
//
// A frame that names a dictionary is refused (orbax writes none). Every read
// and write is bounds-checked: a malformed, truncated or overrunning input
// returns an error code and a message (mico_zstd_error), never touches
// memory outside its buffers and never aborts. The file also holds CRC-32C
// (OCDBT's file checksum) and an entry that decodes many independent frames
// on a pool of threads.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

enum : int {
  kOk = 0,
  kUnsupported = -2,  // a dictionary frame
  kCorrupt = -3,      // malformed, truncated or inconsistent input
  kOverrun = -4,      // the output does not fit its destination
  kNoMemory = -6,
};

struct Failure {
  int code;
};

[[noreturn]] void fail(int code, const char* what) {
  g_error = what;
  throw Failure{code};
}

[[noreturn]] void corrupt(const char* what) { fail(kCorrupt, what); }

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;

uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
uint64_t le64(const uint8_t* p) {
  return le32(p) | (uint64_t(le32(p + 4)) << 32);
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------------------
// checksums
// ---------------------------------------------------------------------------

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
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
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

const Crc32cTable kCrc;

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    uint32_t a = le32(p) ^ crc, b = le32(p + 4);
    crc = kCrc.t[7][a & 0xff] ^ kCrc.t[6][(a >> 8) & 0xff] ^
          kCrc.t[5][(a >> 16) & 0xff] ^ kCrc.t[4][a >> 24] ^
          kCrc.t[3][b & 0xff] ^ kCrc.t[2][(b >> 8) & 0xff] ^
          kCrc.t[1][(b >> 16) & 0xff] ^ kCrc.t[0][b >> 24];
  }
  for (; n; --n, ++p) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p) & 0xff];
  return ~crc;
}

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------

// Little-endian bits read forward (FSE table descriptions). Bits past the
// end read as 0; the caller checks how far it went.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int k) const {  // k <= 25
    uint64_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t(v >> (bit & 7)) & ((1u << k) - 1);
  }
  bool over() const { return bit > 8 * n; }
};

// A backward bitstream (Huffman streams, FSE-coded Huffman weights and
// sequences): the last byte's highest set bit marks the start, and values
// are read from there towards bit 0. Bits below 0 read as 0; `pos` < 0
// says the stream was overread.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackBits(const uint8_t* data, size_t size) : p(data), n(size) {
    if (size == 0) corrupt("an empty bitstream");
    if (data[size - 1] == 0) corrupt("a bitstream without its end mark");
    pos = int64_t(8 * (size - 1)) + highbit(data[size - 1]);
  }
  uint64_t get(int64_t lo, int k) const {  // bits [lo, lo + k), k <= 32
    if (k == 0) return 0;
    if (lo < 0) {
      int64_t have = lo + k;
      return have <= 0 ? 0 : get(0, int(have)) << (-lo);
    }
    size_t byte = size_t(lo >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      memcpy(&v, p + byte, 8);
    } else {
      for (size_t i = 0; byte + i < n && i < 8; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (v >> (lo & 7)) & ((uint64_t(1) << k) - 1);
  }
  uint64_t read(int k) {
    pos -= k;
    return get(pos, k);
  }
  uint64_t peek(int k) const { return get(pos - k, k); }
};

// ---------------------------------------------------------------------------
// FSE tables
// ---------------------------------------------------------------------------

struct FseCell {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: no table yet (a Repeat mode then fails)
  FseCell cell[512];
};

// An FSE table description (RFC 8878 4.1.1) → normalized counts; returns
// the bytes it takes.
size_t read_counts(const uint8_t* src, size_t n, int max_symbol, int max_log,
                   int16_t* norm, int* log_out) {
  if (n == 0) corrupt("an FSE table description is missing");
  ForwardBits b{src, n};
  int log = int(b.peek(4)) + 5;
  b.bit += 4;
  if (log > max_log) corrupt("an FSE table's accuracy is too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      for (;;) {
        int r = int(b.peek(2));
        b.bit += 2;
        n0 += r;
        if (r != 3) break;
        if (b.over()) corrupt("an FSE table description is truncated");
      }
      if (n0 > max_symbol) corrupt("an FSE table names too many symbols");
      while (symbol < n0) norm[symbol++] = 0;
    }
    int max = 2 * threshold - 1 - remaining;
    uint32_t v = b.peek(bits);
    int count;
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      b.bit += bits - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      b.bit += bits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) corrupt("an FSE table's counts overflow its size");
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
    if (b.over()) corrupt("an FSE table description is truncated");
  }
  if (remaining != 1) corrupt("an FSE table's counts do not fill it");
  for (int s = symbol; s <= max_symbol; ++s) norm[s] = 0;
  *log_out = log;
  return (b.bit + 7) / 8;
}

void build_fse(const int16_t* norm, int max_symbol, int log, FseTable& t) {
  int size = 1 << log, high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      if (high < 0) corrupt("an FSE table has too many low-probability symbols");
      t.cell[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cell[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) corrupt("an FSE table's symbols do not fill it");
  for (int u = 0; u < size; ++u) {
    uint32_t state = next[t.cell[u].symbol]++;
    if (state == 0) corrupt("an FSE table cell has no symbol");
    int bits = log - highbit(state);
    t.cell[u].bits = uint8_t(bits);
    t.cell[u].base = uint16_t((state << bits) - size);
  }
  t.log = log;
}

void rle_table(int symbol, FseTable& t) {
  t.cell[0] = FseCell{uint16_t(symbol), 0, 0};
  t.log = 0;
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct Huffman {
  int max_bits = 0;  // 0: no table yet (treeless literals then fail)
  uint8_t symbol[1 << 11];
  uint8_t bits[1 << 11];
};

// The tree description (RFC 8878 4.2.1) → the decoding table; returns the
// bytes it takes.
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h) {
  if (n == 0) corrupt("a Huffman tree description is missing");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  int header = src[0];
  if (header < 128) {
    size_t csize = size_t(header);
    if (csize == 0 || 1 + csize > n) corrupt("a Huffman tree description is truncated");
    int16_t norm[256];
    int log;
    size_t head = read_counts(src + 1, csize, 255, 6, norm, &log);
    if (head >= csize) corrupt("a Huffman weight stream is missing");
    FseTable t;
    int max_symbol = 255;
    while (max_symbol > 0 && norm[max_symbol] == 0) --max_symbol;
    build_fse(norm, max_symbol, log, t);
    BackBits b(src + 1 + head, csize - head);
    uint32_t s1 = uint32_t(b.read(log)), s2 = uint32_t(b.read(log));
    for (;;) {
      if (nw > 253) corrupt("a Huffman tree has too many weights");
      const FseCell& c1 = t.cell[s1];
      w[nw++] = uint8_t(c1.symbol);
      s1 = c1.base + uint32_t(b.read(c1.bits));
      if (b.pos < 0) {
        w[nw++] = uint8_t(t.cell[s2].symbol);
        break;
      }
      const FseCell& c2 = t.cell[s2];
      w[nw++] = uint8_t(c2.symbol);
      s2 = c2.base + uint32_t(b.read(c2.bits));
      if (b.pos < 0) {
        w[nw++] = uint8_t(t.cell[s1].symbol);
        break;
      }
    }
    used = 1 + csize;
  } else {
    nw = header - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) corrupt("a Huffman tree description is truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t byte = src[1 + i / 2];
      w[i] = (i & 1) ? (byte & 15) : (byte >> 4);
    }
    used = 1 + bytes;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) corrupt("a Huffman weight is too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) corrupt("a Huffman tree has no symbols");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) corrupt("a Huffman code is longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) corrupt("the Huffman weights do not make a tree");
  if (nw > 255) corrupt("a Huffman tree has too many symbols");
  w[nw++] = uint8_t(highbit(rest) + 1);
  uint32_t rank[13] = {0};
  for (int i = 0; i < nw; ++i) ++rank[w[i]];
  if (rank[1] < 2 || (rank[1] & 1)) corrupt("the Huffman weights do not make a tree");
  uint32_t start[13] = {0}, next = 0;
  for (int k = 1; k <= max_bits; ++k) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  for (int s = 0; s < nw; ++s) {
    int k = w[s];
    if (!k) continue;
    uint32_t len = 1u << (k - 1);
    for (uint32_t i = start[k]; i < start[k] + len; ++i) {
      h.symbol[i] = uint8_t(s);
      h.bits[i] = uint8_t(max_bits + 1 - k);
    }
    start[k] += len;
  }
  h.max_bits = max_bits;
  return used;
}

void huffman_stream(const uint8_t* src, size_t n, uint8_t* out, size_t count,
                    const Huffman& h) {
  BackBits b(src, n);
  int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = uint32_t(b.peek(mb));
    out[i] = h.symbol[v];
    b.pos -= h.bits[v];
    if (b.pos < -64) corrupt("a Huffman stream is overread");
  }
  if (b.pos != 0) corrupt("a Huffman stream does not end where its symbols do");
}

// ---------------------------------------------------------------------------
// frames
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                              16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// Where decoded bytes go: a fixed destination, or (when `grow`) a malloc'd
// buffer that doubles up to `limit`.
struct Out {
  uint8_t* base;
  size_t cap, pos = 0, limit;
  bool grow;
  void reserve(size_t n) {
    if (n <= cap - pos) return;
    if (!grow || n > limit - pos)
      fail(kOverrun, "the decoded data is larger than its destination");
    size_t want = std::min(limit, std::max(pos + n, 2 * cap + 4096));
    uint8_t* p = static_cast<uint8_t*>(realloc(base, want));
    if (!p) fail(kNoMemory, "out of memory");
    base = p;
    cap = want;
  }
};

struct Frame {
  Out& out;
  size_t start;  // the frame's first byte in out
  uint32_t rep[3] = {1, 4, 8};
  Huffman huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lits;
  explicit Frame(Out& o) : out(o), start(o.pos) {}

  // the literals section → (pointer, count); returns the bytes it takes
  size_t literals(const uint8_t* src, size_t n, const uint8_t** lp, size_t* ln) {
    if (n == 0) corrupt("a block has no literals section");
    int type = src[0] & 3, format = (src[0] >> 2) & 3;
    if (type < 2) {
      size_t head, regen;
      if (format == 0 || format == 2) {
        head = 1;
        regen = src[0] >> 3;
      } else if (format == 1) {
        head = 2;
        if (n < 2) corrupt("a literals header is truncated");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      } else {
        head = 3;
        if (n < 3) corrupt("a literals header is truncated");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      }
      if (regen > kBlockMax) corrupt("a block's literals exceed 128 KiB");
      if (type == 0) {
        if (regen > n - head) corrupt("raw literals are truncated");
        *lp = src + head;
        *ln = regen;
        return head + regen;
      }
      if (head >= n) corrupt("RLE literals are truncated");
      lits.assign(regen, src[head]);
      *lp = lits.data();
      *ln = regen;
      return head + 1;
    }
    size_t head = format < 2 ? 3 : format == 2 ? 4 : 5;
    int bits = format < 2 ? 10 : format == 2 ? 14 : 18;
    bool four = format != 0;
    if (n < head) corrupt("a literals header is truncated");
    uint64_t h = 0;
    for (size_t i = 0; i < head; ++i) h |= uint64_t(src[i]) << (8 * i);
    size_t regen = size_t((h >> 4) & ((1u << bits) - 1));
    size_t csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
    if (regen > kBlockMax) corrupt("a block's literals exceed 128 KiB");
    if (csize > n - head) corrupt("compressed literals are truncated");
    const uint8_t* p = src + head;
    size_t rem = csize;
    if (type == 2) {
      size_t used = read_huffman(p, rem, huf);
      p += used;
      rem -= used;
    } else if (huf.max_bits == 0) {
      corrupt("treeless literals without an earlier Huffman table");
    }
    lits.resize(regen);
    if (!four) {
      huffman_stream(p, rem, lits.data(), regen, huf);
    } else {
      if (rem < 6) corrupt("a literals jump table is truncated");
      size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
      if (s1 + s2 + s3 > rem - 6) corrupt("a literals jump table overruns its section");
      size_t s4 = rem - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) corrupt("four literal streams for too few literals");
      const uint8_t* q = p + 6;
      huffman_stream(q, s1, lits.data(), seg, huf);
      huffman_stream(q + s1, s2, lits.data() + seg, seg, huf);
      huffman_stream(q + s1 + s2, s3, lits.data() + 2 * seg, seg, huf);
      huffman_stream(q + s1 + s2 + s3, s4, lits.data() + 3 * seg, regen - 3 * seg, huf);
    }
    *lp = lits.data();
    *ln = regen;
    return head + csize;
  }

  // one table's mode: returns the bytes its description takes
  size_t table(int mode, const uint8_t* p, size_t n, FseTable& t,
               const int16_t* def, int def_log, int max_symbol, int max_log) {
    switch (mode) {
      case 0: {
        build_fse(def, max_symbol, def_log, t);
        return 0;
      }
      case 1: {
        if (n == 0) corrupt("an RLE sequence table is truncated");
        if (p[0] > max_symbol) corrupt("an RLE sequence code is out of range");
        rle_table(p[0], t);
        return 1;
      }
      case 2: {
        int16_t norm[64];
        int log;
        size_t used = read_counts(p, n, max_symbol, max_log, norm, &log);
        build_fse(norm, max_symbol, log, t);
        return used;
      }
      default:
        if (t.log < 0) corrupt("a repeated sequence table without an earlier one");
        return 0;
    }
  }

  void block(const uint8_t* src, size_t n) {
    size_t block_start = out.pos;
    const uint8_t* lp;
    size_t nlit;
    size_t used = literals(src, n, &lp, &nlit);
    const uint8_t* p = src + used;
    const uint8_t* end = src + n;
    if (p >= end) corrupt("a block has no sequences section");
    size_t nseq = p[0];
    if (nseq < 128) {
      p += 1;
    } else if (nseq < 255) {
      if (end - p < 2) corrupt("a sequence count is truncated");
      nseq = ((nseq - 128) << 8) + p[1];
      p += 2;
    } else {
      if (end - p < 3) corrupt("a sequence count is truncated");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
    }
    size_t litpos = 0;
    if (nseq) {
      if (p >= end) corrupt("the sequence modes are missing");
      int modes = *p++;
      if (modes & 3) corrupt("the sequence modes' reserved bits are set");
      p += table(modes >> 6, p, size_t(end - p), ll, kLLNorm, 6, 35, 9);
      p += table((modes >> 4) & 3, p, size_t(end - p), of, kOFNorm, 5, 28, 8);
      p += table((modes >> 2) & 3, p, size_t(end - p), ml, kMLNorm, 6, 52, 9);
      if (p >= end) corrupt("the sequences bitstream is missing");
      BackBits b(p, size_t(end - p));
      uint32_t sl = uint32_t(b.read(ll.log)), so = uint32_t(b.read(of.log)),
               sm = uint32_t(b.read(ml.log));
      for (size_t i = 0; i < nseq; ++i) {
        const FseCell &cl = ll.cell[sl], &co = of.cell[so], &cm = ml.cell[sm];
        int ofcode = co.symbol;
        if (ofcode > 31) corrupt("an offset code is out of range");
        uint64_t offv = (uint64_t(1) << ofcode) + b.read(ofcode);
        size_t mlen = kMLBase[cm.symbol] + size_t(b.read(kMLBits[cm.symbol]));
        size_t llen = kLLBase[cl.symbol] + size_t(b.read(kLLBits[cl.symbol]));
        if (i + 1 < nseq) {
          sl = cl.base + uint32_t(b.read(cl.bits));
          sm = cm.base + uint32_t(b.read(cm.bits));
          so = co.base + uint32_t(b.read(co.bits));
        }
        if (b.pos < 0) corrupt("the sequences bitstream is overread");
        uint64_t offset;
        if (offv > 3) {
          offset = offv - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        } else {
          int idx = int(offv) - 1 + (llen == 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = uint32_t(offset);
          }
        }
        if (llen > nlit - litpos) corrupt("a sequence overruns the literals");
        if (out.pos - block_start + llen + mlen > kBlockMax)
          corrupt("a block decodes to more than 128 KiB");
        out.reserve(llen + mlen);
        memcpy(out.base + out.pos, lp + litpos, llen);
        out.pos += llen;
        litpos += llen;
        if (offset == 0 || offset > out.pos - start)
          corrupt("a match reaches before the frame's start");
        uint8_t* d = out.base + out.pos;
        const uint8_t* s = d - offset;
        if (offset >= mlen) {
          memcpy(d, s, mlen);
        } else {
          for (size_t k = 0; k < mlen; ++k) d[k] = s[k];
        }
        out.pos += mlen;
      }
      if (b.pos != 0) corrupt("the sequences bitstream does not end with its sequences");
    } else if (p != end) {
      corrupt("a block without sequences has bytes after its literals");
    }
    size_t rest = nlit - litpos;
    if (out.pos - block_start + rest > kBlockMax) corrupt("a block decodes to more than 128 KiB");
    out.reserve(rest);
    memcpy(out.base + out.pos, lp + litpos, rest);
    out.pos += rest;
  }
};

// One zstd frame at src (its magic checked by the caller); returns the
// bytes it takes.
size_t decode_frame(const uint8_t* src, size_t n, Out& out) {
  const uint8_t* p = src + 4;
  const uint8_t* end = src + n;
  if (p >= end) corrupt("a frame header is truncated");
  int fhd = *p++;
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) corrupt("a frame header's reserved bit is set");
  if (!single) {
    if (p >= end) corrupt("a frame header is truncated");
    int exponent = *p++ >> 3;
    if (10 + exponent > 41) corrupt("a frame's window is too large");
  }
  static const int did_size[4] = {0, 1, 2, 4};
  static const int fcs_size[4] = {0, 2, 4, 8};
  size_t dsz = size_t(did_size[did_flag]);
  size_t fsz = size_t(fcs_flag == 0 && single ? 1 : fcs_size[fcs_flag]);
  if (size_t(end - p) < dsz + fsz) corrupt("a frame header is truncated");
  uint64_t dict = 0;
  for (size_t i = 0; i < dsz; ++i) dict |= uint64_t(p[i]) << (8 * i);
  p += dsz;
  if (dict != 0) fail(kUnsupported, "a zstd frame that needs a dictionary");
  bool has_size = fsz > 0;
  uint64_t content = 0;
  for (size_t i = 0; i < fsz; ++i) content |= uint64_t(p[i]) << (8 * i);
  if (fsz == 2) content += 256;
  p += fsz;
  Frame f(out);
  for (;;) {
    if (end - p < 3) corrupt("a block header is truncated");
    uint32_t bh = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
    p += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (size > kBlockMax) corrupt("a block is larger than 128 KiB");
    if (type == 0) {
      if (size > size_t(end - p)) corrupt("a raw block is truncated");
      out.reserve(size);
      memcpy(out.base + out.pos, p, size);
      out.pos += size;
      p += size;
    } else if (type == 1) {
      if (p >= end) corrupt("an RLE block is truncated");
      out.reserve(size);
      memset(out.base + out.pos, *p, size);
      out.pos += size;
      p += 1;
    } else if (type == 2) {
      if (size > size_t(end - p)) corrupt("a compressed block is truncated");
      f.block(p, size);
      p += size;
    } else {
      corrupt("a block of the reserved type");
    }
    if (has_size && out.pos - f.start > content) corrupt("a frame decodes past its content size");
    if (last) break;
  }
  if (has_size && out.pos - f.start != content) corrupt("a frame decodes short of its content size");
  if (checksum) {
    if (end - p < 4) corrupt("a frame's checksum is truncated");
    uint32_t want = le32(p);
    p += 4;
    if (uint32_t(xxh64(out.base + f.start, out.pos - f.start, 0)) != want)
      corrupt("a frame's content checksum does not match");
  }
  return size_t(p - src);
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) corrupt("no zstd frame");
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) corrupt("trailing bytes that are not a frame");
    uint32_t magic = le32(src + pos);
    if (magic == kMagic) {
      pos += decode_frame(src + pos, n - pos, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) corrupt("a skippable frame is truncated");
      size_t size = le32(src + pos + 4);
      if (size > n - pos - 8) corrupt("a skippable frame is truncated");
      pos += 8 + size;
    } else {
      corrupt("not a zstd frame");
    }
  }
}

int guarded(void (*fn)(void*), void* arg) {
  try {
    fn(arg);
    return kOk;
  } catch (const Failure& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return kNoMemory;
  } catch (...) {
    g_error = "an unexpected error";
    return kCorrupt;
  }
}

struct Fixed {
  const uint8_t* src;
  size_t n;
  uint8_t* dst;
  size_t cap;
  size_t written;
};

void run_fixed(void* arg) {
  Fixed& a = *static_cast<Fixed*>(arg);
  Out out{a.dst, a.cap, 0, a.cap, false};
  decode_all(a.src, a.n, out);
  a.written = out.pos;
}

struct Grown {
  const uint8_t* src;
  size_t n, limit;
  Out* out;
};

void run_grown(void* arg) {
  Grown& a = *static_cast<Grown*>(arg);
  decode_all(a.src, a.n, *a.out);
}

}  // namespace

extern "C" {

const char* mico_zstd_error() { return g_error.c_str(); }

// src → a malloc'd buffer of at most `limit` bytes (free with mico_zstd_free).
int mico_zstd_decompress_alloc(const uint8_t* src, size_t n, size_t limit,
                               uint8_t** data, size_t* size) {
  Out out{nullptr, 0, 0, limit, true};
  Grown a{src, n, limit, &out};
  int rc = guarded(run_grown, &a);
  if (rc != kOk) {
    free(out.base);
    out.base = nullptr;
    out.pos = 0;
  }
  *data = out.base;
  *size = out.pos;
  return rc;
}

void mico_zstd_free(uint8_t* p) { free(p); }

// `count` independent decodes, srcs[i] → dsts[i], each of exactly
// dst_lens[i] bytes, on up to `threads` threads. → 0, or the first failing
// job's code with its index in *failed and its message in err.
int mico_zstd_decompress_many(int count, const uint8_t* const* srcs,
                              const size_t* src_lens, uint8_t* const* dsts,
                              const size_t* dst_lens, int threads, int* failed,
                              char* err, size_t err_cap) {
  std::atomic<int> next{0};
  std::mutex lock;
  int code = kOk;
  *failed = -1;
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      {
        std::lock_guard<std::mutex> g(lock);
        if (code != kOk) return;
      }
      Fixed a{srcs[i], src_lens[i], dsts[i], dst_lens[i], 0};
      int rc = guarded(run_fixed, &a);
      if (rc == kOk && a.written != dst_lens[i]) {
        g_error = "a chunk decodes short of its size";
        rc = kCorrupt;
      }
      if (rc != kOk) {
        std::lock_guard<std::mutex> g(lock);
        if (code == kOk || i < *failed) {
          code = rc;
          *failed = i;
          if (err_cap) {
            strncpy(err, g_error.c_str(), err_cap - 1);
            err[err_cap - 1] = 0;
          }
        }
      }
    }
  };
  int n = std::max(1, std::min(threads, count));
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < n; ++t) pool.emplace_back(work);
  } catch (...) {
    // fewer threads than asked: the calling thread does the rest
  }
  work();
  for (auto& t : pool) t.join();
  return code;
}

uint32_t mico_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  return crc32c(p, n, crc);
}

}  // extern "C"
