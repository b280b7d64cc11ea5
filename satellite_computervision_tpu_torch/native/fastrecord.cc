// Fast host-side TFRecord codec: CRC32C, record framing, Example feature
// location. The native tier of the ingestion service (the reference's
// equivalent hot path is tf.data's C++ TFRecordDataset kernels; see
// utils/processing.py:416). Exposed through ctypes (native/__init__.py)
// with a pure-Python fallback in data/tfrecord.py.
//
// Build: g++ -O3 -shared -fPIC fastrecord.cc -o libfastrecord.so

#include <cstdint>
#include <cstring>

namespace {

// Slice-by-8 CRC32C (Castagnoli, reflected 0x82F63B78).
uint32_t kTable[8][256];
bool kInit = false;

void init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int s = 1; s < 8; ++s)
      kTable[s][i] = (kTable[s - 1][i] >> 8) ^ kTable[0][kTable[s - 1][i] & 0xFF];
  kInit = true;
}

inline uint32_t crc32c_impl(const uint8_t* p, size_t len, uint32_t crc) {
  if (!kInit) init_tables();
  crc = ~crc;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    word ^= crc;  // little-endian hosts only (x86/arm LE)
    crc = kTable[7][word & 0xFF] ^ kTable[6][(word >> 8) & 0xFF] ^
          kTable[5][(word >> 16) & 0xFF] ^ kTable[4][(word >> 24) & 0xFF] ^
          kTable[3][(word >> 32) & 0xFF] ^ kTable[2][(word >> 40) & 0xFF] ^
          kTable[1][(word >> 48) & 0xFF] ^ kTable[0][(word >> 56) & 0xFF];
    p += 8;
    len -= 8;
  }
  while (len--) crc = kTable[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// Protobuf varint; returns bytes consumed or 0 on overrun.
inline size_t read_varint(const uint8_t* p, size_t len, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  for (size_t i = 0; i < len && i < 10; ++i) {
    result |= static_cast<uint64_t>(p[i] & 0x7F) << shift;
    if (!(p[i] & 0x80)) {
      *out = result;
      return i + 1;
    }
    shift += 7;
  }
  return 0;
}

// Skip a field of the given wire type; returns bytes consumed or 0.
size_t skip_field(const uint8_t* p, size_t len, uint32_t wire) {
  uint64_t v;
  size_t n;
  switch (wire) {
    case 0:
      return read_varint(p, len, &v);
    case 1:
      return len >= 8 ? 8 : 0;
    case 2:
      n = read_varint(p, len, &v);
      return (n && n + v <= len) ? n + v : 0;
    case 5:
      return len >= 4 ? 4 : 0;
    default:
      return 0;
  }
}

}  // namespace

extern "C" {

uint32_t scv_crc32c(const uint8_t* data, int64_t len) {
  return crc32c_impl(data, static_cast<size_t>(len), 0);
}

uint32_t scv_masked_crc32c(const uint8_t* data, int64_t len) {
  return mask_crc(crc32c_impl(data, static_cast<size_t>(len), 0));
}

// Split a raw (decompressed) TFRecord stream into records.
// offsets/lengths must hold max_records entries. Returns the record count,
// or -1 on framing error, -2 on CRC mismatch (when verify != 0).
int64_t scv_split_records(const uint8_t* buf, int64_t len, int verify,
                          int64_t* offsets, int64_t* lengths,
                          int64_t max_records) {
  int64_t pos = 0, count = 0;
  while (pos + 12 <= len && count < max_records) {
    uint64_t rec_len;
    std::memcpy(&rec_len, buf + pos, 8);
    if (verify) {
      uint32_t stored;
      std::memcpy(&stored, buf + pos + 8, 4);
      if (mask_crc(crc32c_impl(buf + pos, 8, 0)) != stored) return -2;
    }
    int64_t data_start = pos + 12;
    if (data_start + static_cast<int64_t>(rec_len) + 4 > len) return -1;
    if (verify) {
      uint32_t stored;
      std::memcpy(&stored, buf + data_start + rec_len, 4);
      if (mask_crc(crc32c_impl(buf + data_start, rec_len, 0)) != stored)
        return -2;
    }
    offsets[count] = data_start;
    lengths[count] = static_cast<int64_t>(rec_len);
    ++count;
    pos = data_start + rec_len + 4;
  }
  return count;
}

// Locate the packed float payload of a named feature inside a serialized
// Example. Returns the byte offset of the float data (relative to buf) and
// writes its byte length to *out_len; -1 if the feature is missing or not
// a packed FloatList.
int64_t scv_find_float_feature(const uint8_t* buf, int64_t len,
                               const char* name, int64_t* out_len) {
  size_t name_len = std::strlen(name);
  int64_t pos = 0;
  while (pos < len) {
    uint64_t tag;
    size_t n = read_varint(buf + pos, len - pos, &tag);
    if (!n) return -1;
    pos += n;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // Features
      uint64_t fmap_len;
      n = read_varint(buf + pos, len - pos, &fmap_len);
      if (!n) return -1;
      int64_t fmap = pos + n, fmap_end = fmap + fmap_len;
      int64_t p2 = fmap;
      while (p2 < fmap_end) {
        uint64_t tag2;
        size_t n2 = read_varint(buf + p2, fmap_end - p2, &tag2);
        if (!n2) return -1;
        p2 += n2;
        if ((tag2 >> 3) == 1 && (tag2 & 7) == 2) {  // map entry
          uint64_t entry_len;
          n2 = read_varint(buf + p2, fmap_end - p2, &entry_len);
          if (!n2) return -1;
          int64_t entry = p2 + n2, entry_end = entry + entry_len;
          p2 = entry_end;
          // inside entry: field1=key, field2=Feature
          int64_t key_off = -1, key_len = 0, feat_off = -1, feat_len = 0;
          int64_t p3 = entry;
          while (p3 < entry_end) {
            uint64_t tag3;
            size_t n3 = read_varint(buf + p3, entry_end - p3, &tag3);
            if (!n3) return -1;
            p3 += n3;
            uint64_t flen;
            n3 = read_varint(buf + p3, entry_end - p3, &flen);
            if (!n3) return -1;
            if ((tag3 >> 3) == 1)
              key_off = p3 + n3, key_len = flen;
            else if ((tag3 >> 3) == 2)
              feat_off = p3 + n3, feat_len = flen;
            p3 += n3 + flen;
          }
          if (key_off >= 0 && static_cast<size_t>(key_len) == name_len &&
              std::memcmp(buf + key_off, name, name_len) == 0 &&
              feat_off >= 0) {
            // Feature -> field2 FloatList -> field1 packed floats
            int64_t p4 = feat_off, feat_end = feat_off + feat_len;
            while (p4 < feat_end) {
              uint64_t tag4;
              size_t n4 = read_varint(buf + p4, feat_end - p4, &tag4);
              if (!n4) return -1;
              p4 += n4;
              if ((tag4 >> 3) == 2 && (tag4 & 7) == 2) {
                uint64_t fl_len;
                n4 = read_varint(buf + p4, feat_end - p4, &fl_len);
                int64_t fl = p4 + n4, fl_end = fl + fl_len;
                int64_t p5 = fl;
                while (p5 < fl_end) {
                  uint64_t tag5;
                  size_t n5 = read_varint(buf + p5, fl_end - p5, &tag5);
                  if (!n5) return -1;
                  p5 += n5;
                  if ((tag5 >> 3) == 1 && (tag5 & 7) == 2) {
                    uint64_t data_len;
                    n5 = read_varint(buf + p5, fl_end - p5, &data_len);
                    *out_len = static_cast<int64_t>(data_len);
                    return p5 + n5;
                  }
                  size_t sk = skip_field(buf + p5, fl_end - p5, tag5 & 7);
                  if (!sk) return -1;
                  p5 += sk;
                }
                return -1;
              }
              size_t sk = skip_field(buf + p4, feat_end - p4, tag4 & 7);
              if (!sk) return -1;
              p4 += sk;
            }
            return -1;
          }
        } else {
          size_t sk = skip_field(buf + p2, fmap_end - p2, tag2 & 7);
          if (!sk) return -1;
          p2 += sk;
        }
      }
      pos = fmap_end;
    } else {
      size_t sk = skip_field(buf + pos, len - pos, wire);
      if (!sk) return -1;
      pos += sk;
    }
  }
  return -1;
}

// Frame a record in place: writes the 12-byte header and 4-byte footer
// around `data` into `out` (which must hold len + 16 bytes). Returns the
// total framed size.
int64_t scv_frame_record(const uint8_t* data, int64_t len, uint8_t* out) {
  uint64_t len64 = static_cast<uint64_t>(len);
  std::memcpy(out, &len64, 8);
  uint32_t len_crc = mask_crc(crc32c_impl(out, 8, 0));
  std::memcpy(out + 8, &len_crc, 4);
  std::memcpy(out + 12, data, len);
  uint32_t data_crc = mask_crc(crc32c_impl(data, len, 0));
  std::memcpy(out + 12 + len, &data_crc, 4);
  return len + 16;
}

// ---------------------------------------------------------------------------
// TIFF-flavor LZW (compression 5): MSB-first bit packing, 9->12-bit codes
// with libtiff's "early change" (code width bumps one table entry early).
// The hot path of swath-scale COG serving — GDAL emits LZW for most COG
// assets, and the pure-Python codec loops byte-by-byte (~1-2 MB/s); these
// run at hundreds of MB/s and release the GIL via ctypes.
// ---------------------------------------------------------------------------

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxCode = 4096;

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;   // bytes fully written
  uint64_t acc = 0;  // pending bits, MSB-aligned in the low bits
  int nacc = 0;

  bool put(uint32_t code, int nbits) {
    acc = (acc << nbits) | code;
    nacc += nbits;
    while (nacc >= 8) {
      if (pos >= cap) return false;
      out[pos++] = static_cast<uint8_t>((acc >> (nacc - 8)) & 0xFF);
      nacc -= 8;
    }
    return true;
  }
  bool flush() {
    if (nacc > 0) {
      if (pos >= cap) return false;
      out[pos++] = static_cast<uint8_t>((acc << (8 - nacc)) & 0xFF);
      nacc = 0;
    }
    return true;
  }
};

}  // namespace

// Encode `src` into `dst` (capacity dst_cap). Returns bytes written, or -1
// when dst is too small. Matches the decoder below (and the Python
// geo.geotiff._lzw_decode) bit-for-bit, including the early-change width
// schedule and table reset.
int64_t scv_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
  BitWriter w{dst, dst_cap};
  // hash table: (prefix_code << 8 | next_byte) -> code. Open addressing
  // over a power-of-two table comfortably above 4096 entries.
  constexpr int kHashBits = 13;
  constexpr int kHashSize = 1 << kHashBits;  // 8192
  int32_t hash_key[kHashSize];
  int16_t hash_val[kHashSize];
  auto reset_table = [&]() { std::memset(hash_key, -1, sizeof(hash_key)); };

  int nbits = 9;
  int next_code = kFirst;
  reset_table();
  if (!w.put(kClear, nbits)) return -1;
  if (n == 0) {
    if (!w.put(kEoi, nbits) || !w.flush()) return -1;
    return w.pos;
  }

  int32_t prev = src[0];
  for (int64_t i = 1; i < n; ++i) {
    const int32_t key = (prev << 8) | src[i];
    uint32_t h = (static_cast<uint32_t>(key) * 0x9E3779B1u) >> (32 - kHashBits);
    int32_t found = -1;
    while (hash_key[h] != -1) {
      if (hash_key[h] == key) { found = hash_val[h]; break; }
      h = (h + 1) & (kHashSize - 1);
    }
    if (found != -1) {
      prev = found;
      continue;
    }
    if (!w.put(static_cast<uint32_t>(prev), nbits)) return -1;
    hash_key[h] = key;
    hash_val[h] = static_cast<int16_t>(next_code);
    ++next_code;
    // early-change schedule, pinned empirically against the decoder
    // (which itself decodes GDAL-written files): the decoder lags the
    // encoder's table by one entry and bumps at len == 2^nbits - 1, so
    // the matching encoder bump is next_code == 2^nbits
    if (next_code == (1 << nbits) && nbits < 12) ++nbits;
    if (next_code >= kMaxCode - 1) {  // 12-bit table about to overflow
      if (!w.put(kClear, nbits)) return -1;
      nbits = 9;
      next_code = kFirst;
      reset_table();
    }
    prev = src[i];
  }
  if (!w.put(static_cast<uint32_t>(prev), nbits)) return -1;
  // the final data code gets no table insert on this side, but the
  // DECODER still appends an entry for it and may widen before reading
  // the next code — mirror that so EOI lands at the decoder's width
  // (after E emits since clear, decoder table length == next_code here)
  if (next_code == (1 << nbits) - 1 && nbits < 12) ++nbits;
  if (!w.put(kEoi, nbits)) return -1;
  if (!w.flush()) return -1;
  return w.pos;
}

// Decode `src` into `dst` (capacity dst_cap — the caller knows the chunk's
// decompressed size from the TIFF geometry). Returns bytes written, -1 on
// a corrupt stream, -2 when dst is too small.
int64_t scv_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
  // string table: per code, (previous code, final byte, length)
  static thread_local int32_t prev_of[kMaxCode];
  static thread_local uint8_t byte_of[kMaxCode];
  static thread_local int32_t len_of[kMaxCode];
  for (int i = 0; i < 256; ++i) {
    prev_of[i] = -1;
    byte_of[i] = static_cast<uint8_t>(i);
    len_of[i] = 1;
  }
  int table_len = 0;  // valid only after a CLEAR
  int nbits = 9;
  int64_t bitpos = 0;
  const int64_t total = n * 8;
  int32_t prev = -1;
  int64_t out = 0;

  auto emit = [&](int32_t code) -> int64_t {  // returns start offset or -1
    const int32_t len = len_of[code];
    if (out + len > dst_cap) return -1;
    int64_t p = out + len;
    int32_t c = code;
    while (c >= 0) {
      dst[--p] = byte_of[c];
      c = prev_of[c];
    }
    const int64_t start = out;
    out += len;
    return start;
  };

  while (bitpos + nbits <= total) {
    const int64_t byte0 = bitpos >> 3;
    uint32_t window = 0;
    for (int k = 0; k < 4; ++k)
      window = (window << 8) | (byte0 + k < n ? src[byte0 + k] : 0);
    const uint32_t code =
        (window >> (32 - nbits - (bitpos & 7))) & ((1u << nbits) - 1);
    bitpos += nbits;
    if (code == kClear) {
      table_len = kFirst;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (code == kEoi) break;
    if (table_len == 0) return -1;  // no leading clear code
    if (prev < 0) {
      if (code >= 256) return -1;
      if (emit(code) < 0) return -2;
    } else if (static_cast<int>(code) < table_len) {
      const int64_t start = emit(code);
      if (start < 0) return -2;
      if (table_len < kMaxCode) {
        prev_of[table_len] = prev;
        byte_of[table_len] = dst[start];  // first byte of the emitted entry
        len_of[table_len] = len_of[prev] + 1;
        ++table_len;
      }
    } else if (static_cast<int>(code) == table_len && table_len < kMaxCode) {
      // KwKwK: entry = prev + first byte of prev
      prev_of[table_len] = prev;
      len_of[table_len] = len_of[prev] + 1;
      // materialize prev once to find its first byte
      int32_t c = prev;
      while (prev_of[c] >= 0) c = prev_of[c];
      byte_of[table_len] = byte_of[c];
      ++table_len;
      if (emit(table_len - 1) < 0) return -2;
    } else {
      return -1;  // code beyond table
    }
    prev = static_cast<int32_t>(code);
    if (table_len == (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return out;
}

}  // extern "C"
