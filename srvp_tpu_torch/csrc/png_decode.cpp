// Batch PNG decoder of the port's data loaders (KTH and BAIR frame trees),
// bound with ctypes by srvp_tpu_torch/data/native.py and built there with
// g++. Counterpart of native/png_decode.cpp's fast path, self-contained: it
// carries its own inflate (RFC 1950 zlib stream of RFC 1951 deflate blocks,
// adler-32 checked), so it links nothing but the C++ runtime.
//
// It reads 8-bit, non-interlaced gray or RGB files; anything else is
// rejected with a code (below), never decoded another way. channels == 1
// takes a colour file's RED channel (the KTH loaders keep frame[:, :, 0],
// not a luma); channels == 3 needs an RGB file. Chunk CRCs are not checked.
// The plain version is srvp_tpu_torch/data/png.py.
//
// Frames are spread over n_threads workers, each with its own buffers;
// frame i is written at out + offsets[i] (bytes) or, without offsets, at
// out + i * h * w * channels, and its code (0 = decoded) at codes[i].

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Code {
  kOk = 0,
  kIoError = 1,        // cannot open or read the file
  kNotPng = 2,         // no PNG signature
  kBadChunks = 3,      // truncated chunk, or no IHDR
  kWrongSize = 4,      // other width or height than asked
  kUnsupported = 5,    // not 8-bit non-interlaced gray or RGB
  kBadStream = 6,      // corrupt zlib stream, or the wrong amount of data
  kBadFilter = 7,      // a row filter type above 4
  kGrayForRgb = 8,     // a gray file where RGB frames are read
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// ---- inflate

constexpr int kMaxBits = 15;
constexpr int kFastBits = 9;   // codes up to this long decode by one lookup

// A canonical Huffman code: counts of codes by length and symbols in code
// order (the slow, bit-by-bit decode of zlib's puff.c), and a table of the
// next kFastBits stream bits -> (symbol << 4 | length) for short codes.
struct Huffman {
  int16_t count[kMaxBits + 1];
  int16_t symbol[288];
  uint16_t fast[1 << kFastBits];

  // False when the lengths over-subscribe the code.
  bool build(const uint8_t* lengths, int n) {
    std::memset(count, 0, sizeof count);
    for (int s = 0; s < n; ++s) count[lengths[s]]++;
    int left = 1;
    for (int len = 1; len <= kMaxBits; ++len) {
      left = 2 * left - count[len];
      if (left < 0) return false;
    }
    int16_t offs[kMaxBits + 2];
    offs[1] = 0;
    for (int len = 1; len <= kMaxBits; ++len)
      offs[len + 1] = offs[len] + count[len];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbol[offs[lengths[s]]++] = int16_t(s);
    // the fast table: codes are assigned in order of (length, symbol), and
    // the stream holds each code's bits most significant first
    std::memset(fast, 0, sizeof fast);
    int code = 0, index = 0;
    for (int len = 1; len <= kFastBits; ++len) {
      for (int k = 0; k < count[len]; ++k, ++code, ++index) {
        int rev = 0;
        for (int b = 0; b < len; ++b)
          rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < (1 << kFastBits); fill += 1 << len)
          fast[fill] = uint16_t(symbol[index] << 4 | len);
      }
      code <<= 1;
    }
    return true;
  }
};

struct Inflater {
  const uint8_t* in;
  size_t in_len, pos = 0;  // pos: next byte to load into the bit buffer
  uint64_t bits = 0;
  int nbits = 0;
  uint8_t* out;
  size_t out_len, out_pos = 0;
  Huffman lit, dist;

  void refill() {
    while (nbits <= 56) {
      // past the input's end zeros are fed; overrun() tells if they are used
      const uint64_t byte = pos < in_len ? in[pos] : 0;
      ++pos;
      bits |= byte << nbits;
      nbits += 8;
    }
  }
  // bits fed past the end of the input that were actually used
  bool overrun() const { return pos - nbits / 8 > in_len; }

  uint32_t take(int n) {
    if (nbits < n) refill();
    const uint32_t v = uint32_t(bits & ((uint64_t(1) << n) - 1));
    bits >>= n;
    nbits -= n;
    return v;
  }

  int decode(const Huffman& h) {
    if (nbits < kMaxBits) refill();
    const uint16_t e = h.fast[bits & ((1 << kFastBits) - 1)];
    if (e) {
      bits >>= (e & 15);
      nbits -= (e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxBits; ++len) {
      code |= int(take(1));
      const int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -1;  // not a code of h
  }

  bool stored() {
    const int drop = nbits % 8;
    bits >>= drop;
    nbits -= drop;
    const uint32_t len = take(16), nlen = take(16);
    if ((len ^ 0xffff) != nlen || out_pos + len > out_len) return false;
    for (uint32_t i = 0; i < len; ++i) out[out_pos++] = uint8_t(take(8));
    return !overrun();
  }

  bool codes() {
    static const uint16_t len_base[29] = {
        3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
        31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t len_extra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t dist_base[30] = {
        1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
        33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
        1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t dist_extra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                           4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                           9, 9, 10, 10, 11, 11, 12, 12, 13,
                                           13};
    for (;;) {
      const int sym = decode(lit);
      if (sym < 0 || overrun()) return false;
      if (sym < 256) {
        if (out_pos >= out_len) return false;
        out[out_pos++] = uint8_t(sym);
      } else if (sym == 256) {
        return true;
      } else {
        const int li = sym - 257;
        if (li >= 29) return false;
        const size_t len = len_base[li] + take(len_extra[li]);
        const int di = decode(dist);
        if (di < 0 || di >= 30) return false;
        const size_t d = dist_base[di] + take(dist_extra[di]);
        if (overrun() || d > out_pos || out_pos + len > out_len) return false;
        const uint8_t* from = out + out_pos - d;
        for (size_t i = 0; i < len; ++i) out[out_pos + i] = from[i];
        out_pos += len;
      }
    }
  }

  bool fixed() {
    uint8_t lengths[288 + 30];
    int s = 0;
    for (; s < 144; ++s) lengths[s] = 8;
    for (; s < 256; ++s) lengths[s] = 9;
    for (; s < 280; ++s) lengths[s] = 7;
    for (; s < 288; ++s) lengths[s] = 8;
    for (int d = 0; d < 30; ++d) lengths[288 + d] = 5;
    lit.build(lengths, 288);
    dist.build(lengths + 288, 30);
    return codes();
  }

  bool dynamic() {
    static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                      11, 4,  12, 3, 13, 2, 14, 1, 15};
    const int nlen = int(take(5)) + 257, ndist = int(take(5)) + 1,
              ncode = int(take(4)) + 4;
    if (nlen > 286 || ndist > 30) return false;
    uint8_t lengths[320] = {0};
    for (int i = 0; i < ncode; ++i) lengths[order[i]] = uint8_t(take(3));
    Huffman lencode;
    if (!lencode.build(lengths, 19)) return false;
    int i = 0;
    while (i < nlen + ndist) {
      const int sym = decode(lencode);
      if (sym < 0 || overrun()) return false;
      if (sym < 16) {
        lengths[i++] = uint8_t(sym);
        continue;
      }
      int repeat = 0;
      uint8_t value = 0;
      if (sym == 16) {
        if (i == 0) return false;
        value = lengths[i - 1];
        repeat = 3 + int(take(2));
      } else if (sym == 17) {
        repeat = 3 + int(take(3));
      } else {
        repeat = 11 + int(take(7));
      }
      if (i + repeat > nlen + ndist) return false;
      while (repeat--) lengths[i++] = value;
    }
    if (lengths[256] == 0) return false;
    if (!lit.build(lengths, nlen) || !dist.build(lengths + nlen, ndist))
      return false;
    return codes();
  }

  // The zlib stream in `in` -> exactly out_len bytes at `out`.
  bool run() {
    if (in_len < 6) return false;
    const int cmf = in[0], flg = in[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 ||
        (flg & 32))
      return false;
    pos = 2;
    for (;;) {
      const uint32_t last = take(1), type = take(2);
      bool ok = false;
      if (type == 0) ok = stored();
      else if (type == 1) ok = fixed();
      else if (type == 2) ok = dynamic();
      if (!ok || overrun()) return false;
      if (last) break;
    }
    if (out_pos != out_len) return false;
    const int drop = nbits % 8;
    bits >>= drop;
    nbits -= drop;
    uint32_t want = 0;
    for (int k = 0; k < 4; ++k) want = want << 8 | take(8);
    if (overrun()) return false;
    uint32_t a = 1, b = 0;
    for (size_t k = 0; k < out_len; ++k) {
      a += out[k];
      if (a >= 65521) a -= 65521;
      b += a;
      if (b >= 65521) b -= 65521;
    }
    return (b << 16 | a) == want;
  }
};

// ---- row filters

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undoes the filters of h rows of 1 + w * BPP bytes into h * w * BPP pixels.
template <int BPP>
bool defilter(const uint8_t* raw, uint8_t* out, int h, int w) {
  const int stride = w * BPP;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t f = raw[size_t(y) * (stride + 1)];
    const uint8_t* src = raw + size_t(y) * (stride + 1) + 1;
    uint8_t* dst = out + size_t(y) * stride;
    switch (f) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= BPP ? dst[i - BPP] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= BPP ? dst[i - BPP] : 0;
          const int up = prev ? prev[i] : 0;
          dst[i] = uint8_t(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= BPP ? dst[i - BPP] : 0;
          const int up = prev ? prev[i] : 0;
          const int ul = (prev && i >= BPP) ? prev[i - BPP] : 0;
          dst[i] = uint8_t(src[i] + paeth(left, up, ul));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }
  return true;
}

// ---- one file

struct Scratch {
  std::vector<uint8_t> file, idat, raw, pixels;
};

int read_file(const char* path, std::vector<uint8_t>& buf, size_t& size) {
  const int fd = ::open(path, O_RDONLY);
  if (fd < 0) return kIoError;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return kIoError;
  }
  size = size_t(st.st_size);
  if (buf.size() < size) buf.resize(size);
  size_t got = 0;
  while (got < size) {
    const ssize_t r = ::read(fd, buf.data() + got, size - got);
    if (r <= 0) break;
    got += size_t(r);
  }
  ::close(fd);
  return got == size ? kOk : kIoError;
}

int decode_one(const char* path, uint8_t* dst, int h, int w, int channels,
               Scratch& s) {
  size_t size = 0;
  if (const int rc = read_file(path, s.file, size)) return rc;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (size < 8 || std::memcmp(s.file.data(), sig, 8) != 0) return kNotPng;
  const uint8_t* f = s.file.data();
  bool have_header = false;
  int width = 0, height = 0, depth = 0, colour = 0, interlace = 0;
  s.idat.clear();
  size_t off = 8;
  while (off + 8 <= size) {
    const uint32_t len = be32(f + off);
    if (off + 12 + size_t(len) > size) return kBadChunks;
    const uint8_t* type = f + off + 4;
    const uint8_t* data = f + off + 8;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return kBadChunks;
      width = int(be32(data));
      height = int(be32(data + 4));
      depth = data[8];
      colour = data[9];
      interlace = data[12];
      have_header = true;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      s.idat.insert(s.idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + size_t(len);
  }
  if (!have_header) return kBadChunks;
  if (depth != 8 || interlace != 0 || (colour != 0 && colour != 2))
    return kUnsupported;
  if (width != w || height != h) return kWrongSize;
  const int src_c = colour == 0 ? 1 : 3;
  if (channels == 3 && src_c != 3) return kGrayForRgb;

  const size_t stride = size_t(w) * src_c;
  const size_t raw_size = size_t(h) * (stride + 1);
  if (s.raw.size() < raw_size) s.raw.resize(raw_size);
  Inflater inf;
  inf.in = s.idat.data();
  inf.in_len = s.idat.size();
  inf.out = s.raw.data();
  inf.out_len = raw_size;
  if (!inf.run()) return kBadStream;

  if (src_c == channels) {
    const bool ok = src_c == 1 ? defilter<1>(s.raw.data(), dst, h, w)
                               : defilter<3>(s.raw.data(), dst, h, w);
    return ok ? kOk : kBadFilter;
  }
  // an RGB file, gray frames asked: the red channel
  if (s.pixels.size() < size_t(h) * stride)
    s.pixels.resize(size_t(h) * stride);
  if (!defilter<3>(s.raw.data(), s.pixels.data(), h, w)) return kBadFilter;
  for (size_t i = 0; i < size_t(h) * w; ++i) dst[i] = s.pixels[3 * i];
  return kOk;
}

}  // namespace

extern "C" {

// Decodes n PNG files into out (uint8), frame i at out + offsets[i] bytes
// (offsets may be null: frame i at i * h * w * channels), its code at
// codes[i]. Returns the number of files that failed.
int srvp_png_decode(const char* const* paths, int n, uint8_t* out,
                    const int64_t* offsets, int h, int w, int channels,
                    int32_t* codes, int n_threads) {
  const size_t frame_bytes = size_t(h) * w * channels;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    Scratch s;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + (offsets ? size_t(offsets[i]) : frame_bytes * i);
      codes[i] = decode_one(paths[i], dst, h, w, channels, s);
      if (codes[i]) failed.fetch_add(1);
    }
  };
  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads && t < n; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

}  // extern "C"
