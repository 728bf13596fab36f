// K6: JPEG 2000 Part 15 (HTJ2K) decoding of every HT code block of one image.
//
// Original: OpenJPEG 2.5.4's `opj_t1_ht_decode_cblk` (ht_dec.c), host C
// reached through Pillow's Jpeg2KDecode.c; there is no TPU kernel behind
// it. It exists for the reason K5 does: the cleanup pass decodes a quad at
// a time through three interleaved bit streams, and a Python decoder would
// take minutes for a letter page, while the code blocks decode
// independently of each other from their own bytes.
//
// Design (first, simple and right): one thread per code block, as K5. The
// two VLC tables (2 x 1024 uint16, uploaded once a card by j2k_ht_init)
// and the MEL exponents sit in constant memory; each block's five bit
// readers (MagSgn, MEL, VLC, SigProp, MagRef) keep their 64-bit windows in
// registers and read its segments from global memory a byte at a time;
// its significance and SigProp-membership words (4 rows x 8 columns a
// word) and its line state live in a global scratch slice; its samples
// are written in place into the tile-component buffer at out_off /
// out_stride, as K5 writes them, and turned from sign-magnitude to signed
// at the end. The work within a block is a serial chain, so the kernel is
// bound by latency and by the blocks in flight; a warp a block (quads of a
// row pair in parallel once the VLC is walked) is the lever for later work.
//
// Output: int32 coefficients in OpenJPEG's t1 representation, bit for bit
// the plain version in utils/jpeg2000_ht.py::decode_ht_block, including
// its readers' behaviour on malformed data; a block OpenJPEG fails leaves
// its error code (1-4, HT_ERRORS there) in errors[] and stops. No floating
// point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDescFields = 13;
constexpr int kVsc = 0x08;
constexpr uint32_t kAll = 0xFFFFFFFFu;

__constant__ uint16_t kVlc[2 * 1024];  // vlc_tbl0 then vlc_tbl1
__constant__ uint8_t kMelExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
// prefix length (bits 0-1), suffix length (2-4), prefix value (5-7), by the next three VLC bits
__constant__ uint8_t kUvlc[8] = {3 | (5 << 2) | (5 << 5), 1 | (1 << 5), 2 | (2 << 5), 1 | (1 << 5),
                                 3 | (1 << 2) | (3 << 5), 1 | (1 << 5), 2 | (2 << 5), 1 | (1 << 5)};

struct Mel {  // MSB first, 0xFF past its end, the last byte's low nibble set
  const uint8_t* buf;
  int at, size;
  uint64_t tmp;
  int bits;
  bool unstuff;
  int k;
  uint64_t runs;
  int num_runs;
};

__device__ bool mel_init(Mel& m, const uint8_t* buf, int at, int size) {
  m.buf = buf;
  m.at = at;
  m.size = size;
  m.tmp = 0;
  m.bits = 0;
  m.unstuff = false;
  m.k = 0;
  m.runs = 0;
  m.num_runs = 0;
  for (int i = 0; i < 4; ++i) {
    if (m.unstuff && buf[m.at] > 0x8F) return false;
    uint32_t d = m.size > 0 ? buf[m.at] : 0xFFu;
    if (m.size == 1) d |= 0xF;
    if (m.size > 0) m.at += 1;
    m.size -= 1;
    const int nb = 8 - (m.unstuff ? 1 : 0);
    m.tmp = (m.tmp << nb) | d;
    m.bits += nb;
    m.unstuff = d == 0xFF;
  }
  m.tmp <<= (64 - m.bits);
  return true;
}

__device__ void mel_read(Mel& m) {
  if (m.bits > 32) return;
  uint32_t val = kAll;
  int i = 0;
  while (m.size > 0 && i < 32) {
    const uint32_t v = m.buf[m.at] | (m.size == 1 ? 0xFu : 0u);
    m.at += 1;
    m.size -= 1;
    val = (val & ~(0xFFu << i)) | (v << i);
    i += 8;
  }
  int bits = 32 - (m.unstuff ? 1 : 0);
  uint32_t t = 0;
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (val >> (8 * k)) & 0xFF;
    t |= b;
    if (k < 3) {
      const int u = b == 0xFF ? 1 : 0;
      bits -= u;
      t <<= 8 - u;
    }
  }
  m.unstuff = (val >> 24) == 0xFF;
  m.tmp |= (uint64_t)t << (64 - bits - m.bits);
  m.bits += bits;
}

__device__ int mel_get_run(Mel& m) {
  if (m.num_runs == 0) {
    if (m.bits < 6) mel_read(m);
    while (m.bits >= 6 && m.num_runs < 8) {
      const int e = kMelExp[m.k];
      int run;
      if (m.tmp >> 63) {
        run = ((1 << e) - 1) << 1;
        m.k = min(m.k + 1, 12);
        m.tmp <<= 1;
        m.bits -= 1;
      } else {
        run = ((int)((m.tmp >> (63 - e)) & (uint64_t)((1 << e) - 1)) << 1) + 1;
        m.k = max(m.k - 1, 0);
        m.tmp <<= e + 1;
        m.bits -= e + 1;
      }
      m.runs |= (uint64_t)run << (7 * m.num_runs);
      m.num_runs += 1;
    }
  }
  const int t = (int)(m.runs & 0x7F);
  m.runs >>= 7;
  m.num_runs -= 1;
  return t;
}

struct Rev {  // backward, zeros past its start, VLC / MagRef unstuffing
  const uint8_t* buf;
  int at, size;
  uint64_t tmp;
  int bits;
  bool unstuff;
};

__device__ void rev_init(Rev& r, const uint8_t* buf, int at, int size, bool vlc) {
  r.buf = buf;
  r.at = at;
  r.size = size;
  r.tmp = 0;
  r.bits = 0;
  r.unstuff = true;
  if (vlc) {  // the first byte's high nibble only
    const uint32_t d = buf[at];
    r.at -= 1;
    r.tmp = d >> 4;
    r.bits = 4 - ((r.tmp & 7) == 7 ? 1 : 0);
    r.unstuff = (d | 0xF) > 0x8F;
  }
}

__device__ uint32_t rev_fetch(Rev& r) {
  while (r.bits < 32) {
    uint32_t d = 0;
    if (r.size > 0) {
      d = r.buf[r.at];
      r.at -= 1;
    }
    r.size -= 1;
    r.tmp |= (uint64_t)d << r.bits;
    r.bits += 8 - ((r.unstuff && (d & 0x7F) == 0x7F) ? 1 : 0);
    r.unstuff = d > 0x8F;
  }
  return (uint32_t)r.tmp;
}

__device__ uint32_t rev_advance(Rev& r, int n) {
  r.tmp >>= n;
  r.bits -= n;
  return rev_fetch(r);
}

struct Fwd {  // forward, x past its end, 7 bits after 0xFF
  const uint8_t* buf;
  int at, size;
  uint32_t x;
  uint64_t tmp;
  int bits;
  bool unstuff;
};

__device__ void fwd_init(Fwd& f, const uint8_t* buf, int at, int size, uint32_t x) {
  f.buf = buf;
  f.at = at;
  f.size = size;
  f.x = x;
  f.tmp = 0;
  f.bits = 0;
  f.unstuff = false;
}

__device__ uint32_t fwd_fetch(Fwd& f) {
  while (f.bits < 32) {
    uint32_t d = f.x;
    if (f.size > 0) {
      d = f.buf[f.at];
      f.at += 1;
    }
    f.size -= 1;
    f.tmp |= (uint64_t)d << f.bits;
    f.bits += 8 - (f.unstuff ? 1 : 0);
    f.unstuff = d == 0xFF;
  }
  return (uint32_t)f.tmp;
}

__device__ void fwd_advance(Fwd& f, int n) {
  f.tmp >>= n;
  f.bits -= n;
}

// decode_init_uvlc (mode 4: both u_off and a MEL event of one) / decode_noninit_uvlc
__device__ int uvlc(uint32_t vlc, int mode, bool initial, uint32_t* u) {
  if (mode == 0) {
    u[0] = u[1] = 1;
    return 0;
  }
  const uint32_t d1 = kUvlc[vlc & 7];
  vlc >>= d1 & 3;
  int used = d1 & 3;
  const int s1 = (d1 >> 2) & 7;
  if (mode <= 2) {
    const uint32_t v = (d1 >> 5) + (vlc & ((1u << s1) - 1)) + 1;
    u[0] = mode == 1 ? v : 1;
    u[1] = mode == 1 ? 1 : v;
    return used + s1;
  }
  if (initial && mode == 3 && (d1 & 3) > 2) {  // u of the first above 2: the second's in one bit
    u[1] = (vlc & 1) + 2;
    vlc >>= 1;
    u[0] = (d1 >> 5) + (vlc & ((1u << s1) - 1)) + 1;
    return used + 1 + s1;
  }
  const uint32_t d2 = kUvlc[vlc & 7];
  vlc >>= d2 & 3;
  const int s2 = (d2 >> 2) & 7;
  used += (d2 & 3) + s1 + s2;
  const uint32_t u0 = (d1 >> 5) + (vlc & ((1u << s1) - 1));
  vlc >>= s1;
  const uint32_t u1 = (d2 >> 5) + (vlc & ((1u << s2) - 1));
  const uint32_t add = mode == 4 ? 3 : 1;
  u[0] = u0 + add;
  u[1] = u1 + add;
  return used;
}

struct Block {
  uint32_t* dat;  // the block's samples, row stride `stride`
  int stride, w, h, p, nw;
  uint32_t zero_p1;
  bool causal;
  uint32_t* sigma[2];
  uint32_t* mbr[2];
  uint32_t* ls;
  Mel mel;
  Rev vlc, magref;
  Fwd magsgn, sigprop;
  int run;
};

__device__ uint32_t sample(Block& B, uint32_t qinf, uint32_t u_q, int n, int* e) {
  const uint32_t ms = fwd_fetch(B.magsgn);
  const int m = (int)u_q - (int)((qinf >> (12 + n)) & 1);
  fwd_advance(B.magsgn, m);
  const uint32_t v = (ms & ((1u << m) - 1)) | (((qinf >> (8 + n)) & 1) << m) | 1;
  *e = 32 - __clz(v);
  return ((ms & 1) << 31) | ((v + 2) << (B.p - 1));
}

// the cleanup pass over rows y and y + 1; -> an error code or 0
__device__ int row_pair(Block& B, int y) {
  const bool initial = y == 0;
  const uint16_t* tbl = kVlc + (initial ? 0 : 1024);
  uint32_t* sig = B.sigma[(y & 4) ? 1 : 0];
  const int shift = (y & 2) ? 2 : 0;
  const int w = B.w;
  uint32_t* ls = B.ls;
  uint32_t c_q = 0;
  int li = 0;
  uint32_t ls0 = ls[0];
  ls[0] = 0;
  for (int x = 0; x < w; x += 4) {
    uint32_t qinf[2] = {0, 0};
    uint32_t vlc_val = rev_fetch(B.vlc);
    const int nq = x + 2 < w ? 2 : 1;
    for (int k = 0; k < nq; ++k) {
      if (!initial) {  // sigma of NW | N, and of NE | NF, from the line state
        c_q |= k == 0 ? ls0 >> 7 : ls[li + 1] >> 7;
        c_q |= (ls[li + 1 + k] >> 5) & 4;
      }
      qinf[k] = tbl[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {  // a MEL event: is the quad significant?
        B.run -= 2;
        if (B.run != -1) qinf[k] = 0;
        if (B.run < 0) B.run = mel_get_run(B.mel);
      }
      if (initial)
        c_q = ((qinf[k] & 0x10) >> 4) | ((qinf[k] & 0xE0) >> 5);
      else
        c_q = ((qinf[k] & 0x40) >> 5) | ((qinf[k] & 0x80) >> 6);
      vlc_val = rev_advance(B.vlc, qinf[k] & 7);
    }
    const int sh = shift + ((x & 4) ? 16 : 0);
    sig[x >> 3] |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sh;
    sig[x >> 3] |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sh);
    int mode = (int)(((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2));
    if (initial && mode == 3) {
      B.run -= 2;
      if (B.run == -1) mode = 4;
      if (B.run < 0) B.run = mel_get_run(B.mel);
    }
    uint32_t u[2];
    const int used = uvlc(vlc_val, mode, initial, u);
    if (!initial) {  // kappa: the largest exponent above a quad of two or more significant samples
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        const uint32_t e = max(ls0 & 0x7F, ls[li + 1] & 0x7F);
        u[0] += e > 2 ? e - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        const uint32_t e = max(ls[li + 1] & 0x7F, ls[li + 2] & 0x7F);
        u[1] += e > 2 ? e - 2 : 0;
      }
    }
    if (u[0] > B.zero_p1 || u[1] > B.zero_p1) return 3;
    rev_advance(B.vlc, used);
    if (!initial) {
      ls0 = ls[li + 2];
      ls[li + 1] = ls[li + 2] = 0;
    }
    uint32_t locs = 0xFF;
    if (x + 4 > w) locs >>= (x + 4 - w) << 1;
    if (y + 2 > B.h) locs &= 0x55;
    if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs & 0xFF) return 4;
    const int ncol = min(4, w - x);
    for (int col = 0; col < ncol; ++col) {
      const int q = col >> 1, n = (col & 1) * 2;
      if (col & 1) {
        li += 1;
        ls[li] = 0;
      }
      uint32_t* at = B.dat + (size_t)y * B.stride + x + col;
      const uint32_t bit = 1u << (4 * q + n);
      int e;
      if (qinf[q] & (0x10u << n))
        at[0] = sample(B, qinf[q], u[q], n, &e);
      else if (locs & bit)
        at[0] = 0;
      if (qinf[q] & (0x20u << n)) {
        at[B.stride] = sample(B, qinf[q], u[q], n + 1, &e);
        ls[li] = 0x80 | ((col & 1) ? (uint32_t)e : max(ls[li] & 0x7F, (uint32_t)e));
      } else if (locs & (bit << 1)) {
        at[B.stride] = 0;
      }
    }
  }
  return 0;
}

// MagRef over the stripe of rows y0 .. y0 + 3
__device__ void magref_stripe(Block& B, int y0, const uint32_t* sig) {
  const uint32_t half = 1u << (B.p - 2);
  for (int i = 0; i < B.w; i += 8) {
    uint32_t cwd = rev_fetch(B.magref);
    const uint32_t s = sig[i >> 3];
    for (int j = 0; j < 8; ++j)
      for (int r = 0; r < 4; ++r)
        if (s & (1u << (4 * j + r))) {
          uint32_t* at = B.dat + (size_t)(y0 + r) * B.stride + i + j;
          *at = (*at ^ ((1u - (cwd & 1)) << (B.p - 1))) | half;
          cwd >>= 1;
        }
    rev_advance(B.magref, __popc(s));
  }
}

// a stripe's insignificant samples next to its significant ones
__device__ void membership(const Block& B, const uint32_t* sig, uint32_t* mbr) {
  uint32_t prev = 0;
  for (int i = 0; i < B.nw; ++i) {
    uint32_t m = sig[i] | (prev >> 28) | (sig[i] << 4) | (sig[i] >> 4) | (sig[i + 1] << 28);
    prev = sig[i];
    m |= ((m & 0x77777777u) << 1) | ((m & 0xEEEEEEEEu) >> 1);
    mbr[i] = m & ~sig[i];
  }
}

// SigProp over the stripe of rows y0 .. y0 + 3 (its words at index c, the next stripe's at 1 - c)
__device__ void sigprop_stripe(Block& B, int y0, int c, uint32_t pattern, bool with_next) {
  uint32_t *cur_sig = B.sigma[c], *cur_mbr = B.mbr[c], *nxt_sig = B.sigma[1 - c], *nxt_mbr = B.mbr[1 - c];
  if (with_next) {
    uint32_t prev = 0;
    for (int i = 0; i < B.nw; ++i) {
      const uint32_t t = nxt_sig[i] | (prev >> 28) | (nxt_sig[i] << 4) | (nxt_sig[i] >> 4) | (nxt_sig[i + 1] << 28);
      prev = nxt_sig[i];
      if (!B.causal) cur_mbr[i] |= (t & 0x11111111u) << 3;
      cur_mbr[i] &= ~cur_sig[i];
    }
  }
  const uint32_t val = 3u << (B.p - 2);
  const uint32_t prop[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
  for (int i = 0; i < B.w; i += 8) {
    const int wi = i >> 3;
    uint32_t mbr = cur_mbr[wi] & pattern;
    uint32_t new_sig = 0;
    if (mbr) {
      const uint32_t inv_sig = ~cur_sig[wi] & pattern;  // rows past the block's end never join
      for (int n = 0; n < 8; n += 4) {
        uint32_t cwd = fwd_fetch(B.sigprop);
        int cnt = 0;
        const int end = n + 4 + i < B.w ? n + 4 : B.w - i;
        for (int j = n; j < end; ++j)
          for (int r = 0; r < 4; ++r) {
            const uint32_t sm = 1u << (4 * j + r);
            if (mbr & sm) {
              if (cwd & 1) {  // significant now: its later neighbours join
                new_sig |= sm;
                mbr |= (prop[r] << (4 * j)) & inv_sig;
              }
              cwd >>= 1;
              cnt += 1;
            }
          }
        if (new_sig & (0xFFFFu << (4 * n))) {
          for (int j = n; j < end; ++j)
            for (int r = 0; r < 4; ++r)
              if (new_sig & (1u << (4 * j + r))) {
                B.dat[(size_t)(y0 + r) * B.stride + i + j] |= ((cwd & 1) << 31) | val;
                cwd >>= 1;
                cnt += 1;
              }
        }
        fwd_advance(B.sigprop, cnt);
        if (n == 4) {
          uint32_t t = new_sig >> 28;
          t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
          cur_mbr[wi + 1] |= t & ~cur_sig[wi + 1];
        }
      }
    }
    new_sig |= cur_sig[wi];
    const uint32_t ux = (new_sig & 0x88888888u) >> 3;
    const uint32_t tx = ux | (ux << 4) | (ux >> 4);
    if (i > 0) nxt_mbr[wi - 1] |= (ux << 28) & ~nxt_sig[wi - 1];
    nxt_mbr[wi] |= tx & ~nxt_sig[wi];
    nxt_mbr[wi + 1] |= (ux >> 28) & ~nxt_sig[wi + 1];
  }
}

__device__ int decode_block(const uint8_t* __restrict__ data, const int* d, int* out, int* scratch) {
  const int start = d[0], len1 = d[1], len2 = d[2], npasses = d[4], w = d[5], h = d[6];
  const int numbps = d[7], mb = d[8], sty = d[9], out_off = d[10], stride = d[11], scratch_off = d[12];
  Block B;
  B.dat = reinterpret_cast<uint32_t*>(out + out_off);
  B.stride = stride;
  B.w = w;
  B.h = h;
  B.p = numbps;
  B.nw = (w + 7) / 8;
  B.zero_p1 = (uint32_t)(mb + 2 - numbps);
  B.causal = (sty & kVsc) != 0;
  uint32_t* s = reinterpret_cast<uint32_t*>(scratch + scratch_off);
  const int words = 4 * (B.nw + 2) + w / 2 + 4;
  for (int i = 0; i < words; ++i) s[i] = 0;
  B.sigma[0] = s;
  B.sigma[1] = s + (B.nw + 2);
  B.mbr[0] = s + 2 * (B.nw + 2);
  B.mbr[1] = s + 3 * (B.nw + 2);
  B.ls = s + 4 * (B.nw + 2);
  const int lcup = len1;
  const int scup = ((int)data[start + lcup - 1] << 4) + (data[start + lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079) return 1;
  if (!mel_init(B.mel, data, start + lcup - scup, scup - 1)) return 2;
  rev_init(B.vlc, data, start + lcup - 2, scup - 2, true);
  fwd_init(B.magsgn, data, start, lcup - scup, 0xFFu);
  fwd_init(B.sigprop, data, start + lcup, len2, 0u);
  rev_init(B.magref, data, start + lcup + len2 - 1, len2, false);
  B.run = mel_get_run(B.mel);
  int rc = row_pair(B, 0);
  if (rc) return rc;
  for (int y = 2; y < h;) {
    rc = row_pair(B, y);
    if (rc) return rc;
    y += 2;
    if (npasses > 1 && (y & 3) == 0) {
      const int c = (y & 4) ? 1 : 0;  // the stripe that ended at y is at 1 - c, the one before at c
      if (npasses > 2) magref_stripe(B, y - 4, B.sigma[1 - c]);
      membership(B, B.sigma[1 - c], B.mbr[1 - c]);
      if (y >= 8) {
        sigprop_stripe(B, y - 8, c, kAll, true);
        for (int i = 0; i < B.nw + 2; ++i) B.sigma[c][i] = 0;
      }
    }
  }
  if (npasses > 1) {
    if ((h & 3) == 1 || (h & 3) == 2) {
      const int k = (h & 4) ? 1 : 0;
      if (npasses > 2) magref_stripe(B, h & ~3, B.sigma[k]);
      membership(B, B.sigma[k], B.mbr[k]);
    }
    const int first = h - (h > 6 ? (((h + 1) & 3) + 3) : h);
    for (int y = first; y < h; y += 4) {
      const int left = h - y;
      const uint32_t pattern = left == 3 ? 0x77777777u : left == 2 ? 0x33333333u : left == 1 ? 0x11111111u : kAll;
      sigprop_stripe(B, y, (y & 4) ? 1 : 0, pattern, left > 4);
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      uint32_t* at = B.dat + (size_t)y * stride + x;
      const int32_t m = (int32_t)(*at & 0x7FFFFFFFu);
      *at = (uint32_t)((*at & 0x80000000u) ? -m : m);
    }
  return 0;
}

__global__ void j2k_ht_kernel(const uint8_t* __restrict__ data, const int* __restrict__ desc, int nblocks,
                              int* __restrict__ out, int* __restrict__ scratch, int* __restrict__ errors) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const int rc = decode_block(data, desc + (size_t)b * kDescFields, out, scratch);
  if (rc) errors[b] = rc;
}

constexpr int kThreads = 64;

}  // namespace

// the two VLC tables (2 x 1024 uint16 on the host) into the current card's constant memory
extern "C" int j2k_ht_init(const void* tables) {
  return (int)cudaMemcpyToSymbol(kVlc, tables, sizeof(uint16_t) * 2 * 1024);
}

extern "C" int j2k_ht_launch(const void* data, const void* desc, void* out, void* scratch, void* errors, int nblocks,
                             void* stream) {
  if (nblocks <= 0) return 0;
  const int grid = (nblocks + kThreads - 1) / kThreads;
  j2k_ht_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)data, (const int*)desc, nblocks,
                                                             (int*)out, (int*)scratch, (int*)errors);
  return (int)cudaGetLastError();
}

// threads a block, resident blocks a multiprocessor, registers a thread (for reports)
extern "C" int j2k_ht_occupancy(int* threads, int* blocks_per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, j2k_ht_kernel);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, j2k_ht_kernel, kThreads, 0);
  *threads = kThreads;
  *regs = attr.numRegs;
  return (int)rc;
}
