// CRC-32C (Castagnoli, polynomial 0x1EDC6F41, reflected 0x82F63B78) by
// slicing-by-8: the checksum of every checkpoint shard file, the same
// polynomial GCS object checksums use.  Host code, plain C interface,
// loaded through ctypes (which releases the GIL for the call, so the
// checkpoint writer thread checksums while the training loop runs).
//
// Built by tpuframe_torch/_build.py: g++ -O3 -shared -fPIC, no
// dependencies.  Its plain twin is tpuframe_torch/native/__init__.py's
// crc32c_py.

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
};

Tables make_tables() {
  Tables k;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ (0x82F63B78u & (~(crc & 1) + 1));
    k.t[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = k.t[0][i];
    for (int s = 1; s < 8; ++s) {
      crc = k.t[0][crc & 0xFF] ^ (crc >> 8);
      k.t[s][i] = crc;
    }
  }
  return k;
}

// Built once, on first use; C++11 makes the initialisation thread-safe.
const Tables& tables() {
  static const Tables k = make_tables();
  return k;
}

}  // namespace

extern "C" {

// CRC-32C of data[0, n), continuing from ``seed`` (the CRC of the bytes
// before them; 0 to start).
uint32_t tf_crc32c(const uint8_t* data, int64_t n, uint32_t seed) {
  const auto& k = tables().t;
  uint32_t crc = ~seed;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = k[7][crc & 0xFF] ^ k[6][(crc >> 8) & 0xFF] ^
          k[5][(crc >> 16) & 0xFF] ^ k[4][crc >> 24] ^
          k[3][hi & 0xFF] ^ k[2][(hi >> 8) & 0xFF] ^
          k[1][(hi >> 16) & 0xFF] ^ k[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = k[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
