// Minimal PNG codec for the kinfu_tpu data path.
//
// The reference leans on OpenCV's imread/imwrite for its dataset loader
// (depth_sensor.cpp:190-196); the equivalent here is this small
// zlib-backed codec exposed to Python via ctypes (kinfu_tpu/io/native.py).
// Scope: exactly what RGB-D datasets need — 8-bit RGB/RGBA/gray colour
// frames and 16-bit grayscale depth frames, non-interlaced. Returns a
// negative code on anything else.
//
// PNG filters (None/Sub/Up/Average/Paeth) are implemented for decode; the
// encoder always uses filter 0 + zlib default compression, which every
// standard reader (including the reference's OpenCV) accepts.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(uint8_t(x >> 24));
  v.push_back(uint8_t(x >> 16));
  v.push_back(uint8_t(x >> 8));
  v.push_back(uint8_t(x));
}

uint32_t crc_of(const uint8_t* tag, const uint8_t* data, size_t n) {
  uint32_t c = crc32(0L, Z_NULL, 0);
  c = crc32(c, tag, 4);
  if (n) c = crc32(c, data, (uInt)n);
  return c;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = (uInt)in.size();
  std::vector<uint8_t> buf(1 << 20);
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = (uInt)buf.size();
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
    if (rc == Z_OK && zs.avail_in == 0 && zs.avail_out != 0) break;
  }
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

bool deflate_all(const uint8_t* in, size_t n, std::vector<uint8_t>& out) {
  uLongf cap = compressBound((uLong)n);
  out.resize(cap);
  if (compress2(out.data(), &cap, in, (uLong)n, Z_DEFAULT_COMPRESSION) != Z_OK)
    return false;
  out.resize(cap);
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out.resize((size_t)n);
  size_t got = n ? std::fread(out.data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

}  // namespace

extern "C" {

// Decode a PNG file. Writes raw big-endian samples (as stored in the PNG)
// row-major into out. Returns 0 on success; negative error codes otherwise.
int kio_read_png(const char* path, int* width, int* height, int* channels,
                 int* bit_depth, void* out, size_t out_capacity) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) return -1;
  if (file.size() < 8 || std::memcmp(file.data(), kSig, 8) != 0) return -2;

  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1;
  std::vector<uint8_t> idat;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (pos + 12 + len > file.size()) return -3;
    const uint8_t* tag = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (len != 13) return -3;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      color = data[9];
      if (data[12] != 0) return -4;  // interlaced unsupported
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || idat.empty()) return -3;

  int ch;
  switch (color) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -4;     // palette unsupported
  }
  if (depth != 8 && depth != 16) return -4;

  size_t bpp = (size_t)ch * (depth / 8);       // bytes per pixel
  size_t stride = (size_t)w * bpp;             // bytes per row (no filter byte)
  std::vector<uint8_t> raw;
  raw.reserve(h * (stride + 1));
  if (!inflate_all(idat, raw)) return -5;
  if (raw.size() < h * (stride + 1)) return -5;
  if (out_capacity < h * stride) return -6;

  uint8_t* dst = (uint8_t*)out;
  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* drow = dst + y * stride;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= bpp ? drow[x - bpp] : 0;
      int b = prev[x];
      int c = x >= bpp ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -5;
      }
      drow[x] = uint8_t(v);
    }
    std::memcpy(prev.data(), drow, stride);
  }
  *width = (int)w;
  *height = (int)h;
  *channels = ch;
  *bit_depth = depth;
  return 0;
}

// Encode a PNG (filter 0 rows, zlib-compressed). `data` holds raw
// big-endian samples row-major. channels in {1, 3}, bit_depth in {8, 16}.
int kio_write_png(const char* path, int width, int height, int channels,
                  int bit_depth, const void* data) {
  if ((channels != 1 && channels != 3) || (bit_depth != 8 && bit_depth != 16))
    return -4;
  size_t stride = (size_t)width * channels * (bit_depth / 8);
  std::vector<uint8_t> raw((stride + 1) * height);
  const uint8_t* src = (const uint8_t*)data;
  for (int y = 0; y < height; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: None
    std::memcpy(&raw[y * (stride + 1) + 1], src + y * stride, stride);
  }
  std::vector<uint8_t> comp;
  if (!deflate_all(raw.data(), raw.size(), comp)) return -5;

  std::vector<uint8_t> out(kSig, kSig + 8);
  auto chunk = [&](const char* tag, const uint8_t* d, size_t n) {
    put_be32(out, (uint32_t)n);
    out.insert(out.end(), tag, tag + 4);
    if (n) out.insert(out.end(), d, d + n);
    put_be32(out, crc_of((const uint8_t*)tag, d, n));
  };
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(uint32_t(width) >> 24);
  ihdr[1] = uint8_t(uint32_t(width) >> 16);
  ihdr[2] = uint8_t(uint32_t(width) >> 8);
  ihdr[3] = uint8_t(width);
  ihdr[4] = uint8_t(uint32_t(height) >> 24);
  ihdr[5] = uint8_t(uint32_t(height) >> 16);
  ihdr[6] = uint8_t(uint32_t(height) >> 8);
  ihdr[7] = uint8_t(height);
  ihdr[8] = uint8_t(bit_depth);
  ihdr[9] = channels == 1 ? 0 : 2;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", comp.data(), comp.size());
  chunk("IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t put = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return put == out.size() ? 0 : -1;
}

}  // extern "C"
