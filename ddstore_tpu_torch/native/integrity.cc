#include "integrity.h"

#include <cstdlib>
#include <cstring>

namespace dds {
namespace integrity {

namespace {

// XXH64 constants (public-domain algorithm, Yann Collet).
constexpr uint64_t kP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ULL;

inline uint64_t Rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t Read64(const unsigned char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // unaligned-safe; little-endian targets only
  return v;
}

inline uint32_t Read32(const unsigned char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t Round(uint64_t acc, uint64_t input) {
  acc += input * kP2;
  acc = Rotl(acc, 31);
  return acc * kP1;
}

inline uint64_t MergeRound(uint64_t acc, uint64_t val) {
  acc ^= Round(0, val);
  return acc * kP1 + kP4;
}

}  // namespace

uint64_t Hash64(const void* data, size_t n, uint64_t seed) {
  const unsigned char* p = static_cast<const unsigned char*>(data);
  const unsigned char* end = p + n;
  uint64_t h;
  if (n >= 32) {
    const unsigned char* limit = end - 32;
    uint64_t v1 = seed + kP1 + kP2;
    uint64_t v2 = seed + kP2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - kP1;
    do {
      v1 = Round(v1, Read64(p));
      v2 = Round(v2, Read64(p + 8));
      v3 = Round(v3, Read64(p + 16));
      v4 = Round(v4, Read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = Rotl(v1, 1) + Rotl(v2, 7) + Rotl(v3, 12) + Rotl(v4, 18);
    h = MergeRound(h, v1);
    h = MergeRound(h, v2);
    h = MergeRound(h, v3);
    h = MergeRound(h, v4);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= Round(0, Read64(p));
    h = Rotl(h, 27) * kP1 + kP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(Read32(p)) * kP1;
    h = Rotl(h, 23) * kP2 + kP3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * kP5;
    h = Rotl(h, 11) * kP1;
    ++p;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

uint64_t RowSum(const void* row, int64_t row_bytes, int64_t local_row,
                uint64_t seed) {
  // Salt by the owner-local row index (splitmix-style spread so
  // adjacent rows get unrelated seeds): a serve that returns the right
  // bytes of the WRONG row must fail verification too.
  const uint64_t salt =
      (static_cast<uint64_t>(local_row) + 1) * 0x9E3779B97F4A7C15ULL;
  return Hash64(row, static_cast<size_t>(row_bytes), seed ^ salt);
}

uint64_t SeedFromEnv() {
  if (const char* env = std::getenv("DDSTORE_VERIFY_SEED"))
    return std::strtoull(env, nullptr, 10);
  return 0;
}

}  // namespace integrity
}  // namespace dds
