// Native secure-aggregation kernels for the cross-host path (host C++).
//
// The reference (vantage6) has no native code (SURVEY.md §2.2); its secure
// sums live in algorithm repos as Paillier bigint — seconds per vector. This
// library is the native equivalent for payloads that LEAVE the card's host
// (node -> server REST deployment): each station adds pairwise ChaCha20
// keystream masks (mod 2^32) to its quantized update before upload; the
// masks cancel exactly in the server-side modular sum. Aggregation on the
// card never comes here — it runs as the port's collectives.
//
// The port's copy of vantage6_tpu/native/secureagg.cpp, kept bit for bit
// (the two libraries produce the same streams, masks and sums). Contract
// mirrored bit-for-bit by the numpy fallback in
// vantage6_tpu_torch/native/__init__.py:
//   - ChaCha20 (RFC 8439 block function, 20 rounds, counter from 0)
//   - pair (i, j), i < j: 96-bit nonce = words [i, j, 0] (little-endian)
//   - station s adds +mask(i,j) if s == i else -mask(i,j), mod 2^32
//   - the `seed` these kernels receive is a PER-AGGREGATION subkey
//     (HMAC-SHA256 of the provisioned long-term seed and an aggregation
//     tag, derived host-side in derive_mask_key): the nonce carries no
//     round identity, so a key reused across two aggregations would emit
//     identical masks and let the relay difference two uploads to unmask
//     them. Callers must never feed the long-term seed here directly.
//
// Build: g++ -O3 -shared -fPIC (no external deps).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

inline uint32_t rotl(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

inline void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d ^= a; d = rotl(d, 16);
  c += d; b ^= c; b = rotl(b, 12);
  a += b; d ^= a; d = rotl(d, 8);
  c += d; b ^= c; b = rotl(b, 7);
}

// One ChaCha20 block: 16 words of keystream.
void chacha20_block(const uint32_t key[8], uint32_t counter,
                    const uint32_t nonce[3], uint32_t out[16]) {
  static const uint32_t kConst[4] = {0x61707865u, 0x3320646eu, 0x79622d32u,
                                     0x6b206574u};
  uint32_t s[16];
  s[0] = kConst[0]; s[1] = kConst[1]; s[2] = kConst[2]; s[3] = kConst[3];
  std::memcpy(s + 4, key, 32);
  s[12] = counter;
  s[13] = nonce[0]; s[14] = nonce[1]; s[15] = nonce[2];
  uint32_t w[16];
  std::memcpy(w, s, sizeof(w));
  for (int r = 0; r < 10; ++r) {
    quarter(w[0], w[4], w[8], w[12]);
    quarter(w[1], w[5], w[9], w[13]);
    quarter(w[2], w[6], w[10], w[14]);
    quarter(w[3], w[7], w[11], w[15]);
    quarter(w[0], w[5], w[10], w[15]);
    quarter(w[1], w[6], w[11], w[12]);
    quarter(w[2], w[7], w[8], w[13]);
    quarter(w[3], w[4], w[9], w[14]);
  }
  for (int i = 0; i < 16; ++i) out[i] = w[i] + s[i];
}

}  // namespace

extern "C" {

// Fill `out[n]` with ChaCha20 keystream words. `key` is 32 bytes
// (little-endian words); nonce96 is 12 bytes.
void v6t_chacha20_stream(const uint8_t* key_bytes, const uint8_t* nonce_bytes,
                         uint32_t* out, size_t n) {
  uint32_t key[8], nonce[3];
  std::memcpy(key, key_bytes, 32);
  std::memcpy(nonce, nonce_bytes, 12);
  uint32_t block[16];
  uint32_t counter = 0;
  size_t i = 0;
  while (i < n) {
    chacha20_block(key, counter++, nonce, block);
    size_t take = (n - i) < 16 ? (n - i) : 16;
    std::memcpy(out + i, block, take * sizeof(uint32_t));
    i += take;
  }
}

// Add this station's pairwise masks to `buf[n]` in place (wrapping int32).
// seed: 32-byte shared federation seed. For every pair (i, j), i < j, the
// mask stream's 96-bit nonce is [i, j, 0]; station i adds +, station j adds -.
void v6t_pairwise_mask_i32(const uint8_t* seed, uint32_t station,
                           uint32_t n_stations, int32_t* buf, size_t n) {
  uint32_t key[8];
  std::memcpy(key, seed, 32);
  uint32_t* stream = new uint32_t[n];
  for (uint32_t other = 0; other < n_stations; ++other) {
    if (other == station) continue;
    uint32_t i = station < other ? station : other;
    uint32_t j = station < other ? other : station;
    uint32_t nonce[3] = {i, j, 0};
    uint32_t block[16];
    uint32_t counter = 0;
    size_t pos = 0;
    while (pos < n) {
      chacha20_block(key, counter++, nonce, block);
      size_t take = (n - pos) < 16 ? (n - pos) : 16;
      std::memcpy(stream + pos, block, take * sizeof(uint32_t));
      pos += take;
    }
    if (station == i) {
      for (size_t k = 0; k < n; ++k)
        buf[k] = (int32_t)((uint32_t)buf[k] + stream[k]);
    } else {
      for (size_t k = 0; k < n; ++k)
        buf[k] = (int32_t)((uint32_t)buf[k] - stream[k]);
    }
  }
  delete[] stream;
}

// Quantize float -> fixed-point int32 with round-half-away-from-zero
// (matches numpy's np.round... careful: np.round is half-to-even; we use
// rint to match np.rint exactly on both sides).
void v6t_quantize_f32(const float* in, int32_t* out, size_t n, float scale) {
  for (size_t k = 0; k < n; ++k) {
    out[k] = (int32_t)__builtin_rintf(in[k] * scale);
  }
}

void v6t_dequantize_i32(const int32_t* in, float* out, size_t n, float scale) {
  for (size_t k = 0; k < n; ++k) out[k] = (float)in[k] / scale;
}

// Wrapping column sum over S stacked int32 vectors: out[k] = sum_s x[s][k]
// (mod 2^32). This is the server-side aggregation of masked uploads.
void v6t_sum_i32_wrap(const int32_t* stacked, int32_t* out, size_t s,
                      size_t n) {
  for (size_t k = 0; k < n; ++k) out[k] = 0;
  for (size_t row = 0; row < s; ++row) {
    const int32_t* x = stacked + row * n;
    for (size_t k = 0; k < n; ++k)
      out[k] = (int32_t)((uint32_t)out[k] + (uint32_t)x[k]);
  }
}

}  // extern "C"
