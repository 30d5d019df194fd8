// CRC32C (Castagnoli, reflected polynomial 0x82F63B78) of a buffer.
//
// The checksum the JAX package writes into its checkpoint manifests
// whenever google_crc32c imports where they were written. The port
// computes it here, so a machine without that package validates them
// too. pt_crc32c_extend(crc, buf, n) continues a running value as
// google_crc32c.extend does: pt_crc32c_extend(0, data, n) is the CRC32C of
// data. On x86-64 with SSE4.2 the crc32 instruction takes 8 bytes a step;
// elsewhere a slicing-by-8 table does.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

uint32_t g_table[8][256];

void build_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    g_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      g_table[t][i] = (g_table[t - 1][i] >> 8) ^ g_table[0][g_table[t - 1][i] & 0xFF];
}

uint32_t crc_table(uint32_t c, const unsigned char* p, size_t n) {
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= c;
    c = g_table[7][w & 0xFF] ^ g_table[6][(w >> 8) & 0xFF] ^
        g_table[5][(w >> 16) & 0xFF] ^ g_table[4][(w >> 24) & 0xFF] ^
        g_table[3][(w >> 32) & 0xFF] ^ g_table[2][(w >> 40) & 0xFF] ^
        g_table[1][(w >> 48) & 0xFF] ^ g_table[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ g_table[0][(c ^ *p++) & 0xFF];
  return c;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc_sse42(uint32_t c, const unsigned char* p, size_t n) {
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c64 = __builtin_ia32_crc32di(c64, w);
    p += 8;
    n -= 8;
  }
  c = static_cast<uint32_t>(c64);
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return c;
}
#endif

}  // namespace

extern "C" {

// The table route alone (what a machine without SSE4.2 runs).
uint32_t pt_crc32c_extend_portable(uint32_t crc, const unsigned char* buf,
                                   size_t n) {
  static const bool table_ready = (build_table(), true);  // once, thread-safe
  (void)table_ready;
  return ~crc_table(~crc, buf, n);
}

uint32_t pt_crc32c_extend(uint32_t crc, const unsigned char* buf, size_t n) {
  uint32_t c = ~crc;
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2")) return ~crc_sse42(c, buf, n);
#endif
  return pt_crc32c_extend_portable(crc, buf, n);
}

}  // extern "C"
