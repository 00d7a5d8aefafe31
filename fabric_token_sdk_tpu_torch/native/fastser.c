/* fastser — native host helpers for the token framework runtime.
 *
 * Batch SHA-256 over many concatenated transcripts: the host-side cost of
 * batched Fiat-Shamir challenge recomputation (one digest per proof in a
 * verified block). Plain C99, no dependencies; built on demand and loaded
 * via ctypes (see __init__.py), with a hashlib fallback.
 *
 * Reference counterpart: the per-proof sha256 calls spread through
 * token/core/zkatdlog/crypto (Curve.HashToZr).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_block(uint32_t h[8], const uint8_t *p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = ROTR(w[i - 15], 7) ^ ROTR(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROTR(w[i - 2], 17) ^ ROTR(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
    uint32_t ch = (e & f) ^ ((~e) & g);
    uint32_t t1 = hh + S1 + ch + K[i] + w[i];
    uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + mj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha256_one(const uint8_t *msg, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t i = 0;
  for (; i + 64 <= len; i += 64) sha256_block(h, msg + i);
  uint8_t tail[128];
  size_t rem = len - i;
  memcpy(tail, msg + i, rem);
  tail[rem] = 0x80;
  size_t padlen = (rem < 56) ? 64 : 128;
  memset(tail + rem + 1, 0, padlen - rem - 1 - 8);
  uint64_t bits = (uint64_t)len * 8;
  for (int j = 0; j < 8; j++)
    tail[padlen - 1 - j] = (uint8_t)(bits >> (8 * j));
  sha256_block(h, tail);
  if (padlen == 128) sha256_block(h, tail + 64);
  for (int j = 0; j < 8; j++) {
    out[4 * j] = (uint8_t)(h[j] >> 24);
    out[4 * j + 1] = (uint8_t)(h[j] >> 16);
    out[4 * j + 2] = (uint8_t)(h[j] >> 8);
    out[4 * j + 3] = (uint8_t)h[j];
  }
}

/* Hash `n` messages packed into `buf` at byte offsets offs[0..n] (offs has
 * n+1 entries; message i spans [offs[i], offs[i+1])); 32*n output bytes. */
void sha256_batch(const uint8_t *buf, const uint64_t *offs, uint64_t n,
                  uint8_t *out) {
  for (uint64_t i = 0; i < n; i++)
    sha256_one(buf + offs[i], (size_t)(offs[i + 1] - offs[i]), out + 32 * i);
}

/* Single-shot entry, handy for sanity checks. */
void sha256_single(const uint8_t *msg, uint64_t len, uint8_t *out) {
  sha256_one(msg, (size_t)len, out);
}
