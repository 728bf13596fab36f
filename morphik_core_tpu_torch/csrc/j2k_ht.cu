// K6: JPEG 2000 Part 15 (HTJ2K) decoding of every HT code block of one image.
//
// Original: OpenJPEG 2.5.4's `opj_t1_ht_decode_cblk` (ht_dec.c), host C
// reached through Pillow's Jpeg2KDecode.c; there is no TPU kernel behind
// it. It exists for the reason K5 does: the cleanup pass decodes a quad at
// a time through three interleaved bit streams, and a Python decoder would
// take minutes for a letter page, while the code blocks decode
// independently of each other from their own bytes.
//
// What bounds it: within a block, the cleanup's VLC and MEL walk is one
// serial chain (each quad's context depends on its neighbours' significance)
// and so is SigProp's scan of a stripe; neither bytes nor a peak arithmetic
// rate bound it, and tensor cores, wgmma and fp8 have no part here.
//
// Design: a warp a code block, as K5. Persistent warps (one a thread block,
// as many as the occupancy query keeps resident) take blocks from an atomic
// counter in the order `pack_ht_blocks` sorted them (heaviest first). A
// block's segments are copied into the warp's shared memory with cp.async
// (a block larger than the buffer reads global memory), and the readers read
// them there. Its samples (w x h, written to the tile buffer once at the
// end, coalesced), its significance and SigProp-membership words (4 rows x 8
// columns a word), its line state and each row pair's quads sit in shared
// memory too. The cleanup runs a row pair at a time: the serial VLC / MEL
// walk (uniform code: every lane runs it alike) leaves each quad's
// significance, EMB bits and U_q in shared memory; then the lanes decode the
// MagSgn words of 32 quads at once, each from its own bit offset, the
// offsets a warp prefix sum of the quads' MagSgn bit counts; the exponents
// of their lower row give the line state the next row pair's walk reads.
// MagSgn and MagRef are read from rings of their unstuffed bits, which the
// lanes fill 32 bytes at a time (each byte's bit position a prefix sum of
// 7 or 8 bits a byte). MagRef runs a stripe column a lane, its offsets a
// prefix count of the significant samples; SigProp keeps its order (a
// sample's decision depends on the ones before it) and stays serial, with
// the membership words built by the lanes. The two VLC tables (2 x 1024
// uint16, uploaded once a card by j2k_ht_init) and the MEL exponents sit in
// constant memory.
//
// Output: int32 coefficients in OpenJPEG's t1 representation, bit for bit
// the plain version in utils/jpeg2000_ht.py::decode_ht_block, including
// its readers' behaviour on malformed data; a block OpenJPEG fails leaves
// its error code (1-4, HT_ERRORS there) in errors[] and writes nothing. No
// floating point.

#include "warp.cuh"

namespace {

constexpr int kDescFields = 13;
constexpr int kVsc = 0x08;
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr int kRing = 256;  // words of a stream's ring of unstuffed bits

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
        m.k = m.k + 1 < 12 ? m.k + 1 : 12;
        m.tmp <<= 1;
        m.bits -= 1;
      } else {
        run = ((int)((m.tmp >> (63 - e)) & (uint64_t)((1 << e) - 1)) << 1) + 1;
        m.k = m.k > 0 ? m.k - 1 : 0;
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

struct Rev {  // backward, zeros past its start, VLC unstuffing
  const uint8_t* buf;
  int at, size;
  uint64_t tmp;
  int bits;
  bool unstuff;
};

__device__ void rev_init_vlc(Rev& r, const uint8_t* buf, int at, int size) {
  r.buf = buf;
  r.at = at;
  r.size = size;
  const uint32_t d = buf[at];  // the first byte's high nibble only
  r.at -= 1;
  r.tmp = d >> 4;
  r.bits = 4 - ((r.tmp & 7) == 7 ? 1 : 0);
  r.unstuff = (d | 0xF) > 0x8F;
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

// A stream read at random bit offsets (MagSgn forward, MagRef backward): its unstuffed bits in a ring of
// kRing shared words, bit p at word (p / 32) % kRing. The lanes add 32 bytes at a time: byte k (in reading
// order; x past the stream's `size`) ORed in at the sum of the bits of the bytes before it, 7 where the
// unstuffing drops one (forward: after 0xFF; backward: a byte whose low 7 bits are set after one above
// 0x8F), else 8, as the serial readers above place them.
struct Ring {
  const uint8_t* buf;
  int at, size, dir;
  uint32_t x;
  bool backward;
  uint32_t* w;
  int next;    // the next byte to add
  int pos;     // its bit position
  int clear;   // words below this (absolute) index are zeroed for use
  bool prev;   // the unstuffing state the next byte sees
};

__device__ void ring_init(Ring& r, const uint8_t* buf, int at, int size, bool backward, uint32_t x, uint32_t* w) {
  r.buf = buf;
  r.at = at;
  r.size = size;
  r.dir = backward ? -1 : 1;
  r.x = x;
  r.backward = backward;
  r.w = w;
  r.next = r.pos = r.clear = 0;
  r.prev = backward;
}

__device__ __forceinline__ uint32_t ring_byte(const Ring& r, int k) { return k < r.size ? r.buf[r.at + r.dir * k] : r.x; }

// the stream's bits below `upto` into the ring
__device__ void ring_fill(Ring& r, int upto) {
  while (r.pos < upto) {
    const int clear_to = ((r.pos + 8 * 33) >> 5) + 1;  // the words 32 more bytes can reach, zeroed first
    if (clear_to > r.clear) {
      const int from = r.clear;
      warp::strided(clear_to - from, [&](int t) { r.w[(from + t) & (kRing - 1)] = 0; });
      r.clear = clear_to;
    }
    const int total = warp::scan(
        [&](int l) {
          const int k = r.next + l;
          const uint32_t d = ring_byte(r, k);
          if (!r.backward) return 8 - (l == 0 ? (r.prev ? 1 : 0) : (ring_byte(r, k - 1) == 0xFFu ? 1 : 0));
          const bool u = l == 0 ? r.prev : ring_byte(r, k - 1) > 0x8Fu;
          return 8 - ((u && (d & 0x7F) == 0x7F) ? 1 : 0);
        },
        [&](int l, int, int prefix) {
          const uint32_t d = ring_byte(r, r.next + l);
          const int p = r.pos + prefix, s = p & 31;
          warp::atomic_or(&r.w[(p >> 5) & (kRing - 1)], d << s);
          if (s > 24) warp::atomic_or(&r.w[((p >> 5) + 1) & (kRing - 1)], d >> (32 - s));
        });
    const uint32_t last = ring_byte(r, r.next + 31);
    r.prev = r.backward ? last > 0x8Fu : last == 0xFFu;
    r.pos += total;
    r.next += 32;
  }
}

// 32 bits from bit p on (p below the filled bits less 31)
__device__ __forceinline__ uint32_t ring_bits(const Ring& r, int p) {
  const int i = p >> 5, s = p & 31;
  const uint32_t lo = r.w[i & (kRing - 1)];
  return s ? (lo >> s) | (r.w[(i + 1) & (kRing - 1)] << (32 - s)) : lo;
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
  uint32_t* dat;  // the block's samples in shared memory, row-major (stride w), sign-magnitude
  int w, h, p, nw;
  uint32_t zero_p1;
  bool causal;
  uint32_t* sigma[2];  // cleanup significance, 4 rows x 8 columns a word
  uint32_t* mbr[2];    // SigProp membership, likewise
  uint32_t* ls;        // line state: 0x80 | the largest exponent of the row above, by column pair (2j - 1, 2j)
  uint32_t* qi;        // a row pair's quads: qinf | U_q << 16
  uint8_t* ecol;       // a row pair's lower-row exponents by column (0: not significant)
  int* offs;           // 32 lanes' bit offsets
  Mel mel;
  Rev vlc;
  Fwd sigprop;
  Ring magsgn, magref;
  int ms_pos, mr_pos;  // the next MagSgn / MagRef bit
  int run;
};

// the cleanup's VLC / MEL walk over rows y and y + 1: each quad's qinf and U_q into B.qi; -> an error code or 0
__device__ int walk(Block& B, int y) {
  const bool initial = y == 0;
  const uint16_t* tbl = kVlc + (initial ? 0 : 1024);
  uint32_t* sig = B.sigma[(y & 4) ? 1 : 0];
  const int shift = (y & 2) ? 2 : 0;
  const int w = B.w;
  const uint32_t* ls = B.ls;
  uint32_t c_q = 0;
  for (int x = 0; x < w; x += 4) {
    const int li = x >> 1;
    const uint32_t ls0 = ls[li];
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
        const uint32_t e = (ls0 & 0x7F) > (ls[li + 1] & 0x7F) ? ls0 & 0x7F : ls[li + 1] & 0x7F;
        u[0] += e > 2 ? e - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        const uint32_t e = (ls[li + 1] & 0x7F) > (ls[li + 2] & 0x7F) ? ls[li + 1] & 0x7F : ls[li + 2] & 0x7F;
        u[1] += e > 2 ? e - 2 : 0;
      }
    }
    if (u[0] > B.zero_p1 || u[1] > B.zero_p1) return 3;
    rev_advance(B.vlc, used);
    uint32_t locs = 0xFF;
    if (x + 4 > w) locs >>= (x + 4 - w) << 1;
    if (y + 2 > B.h) locs &= 0x55;
    if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs & 0xFF) return 4;
    B.qi[li] = qinf[0] | (u[0] << 16);
    if (nq == 2) B.qi[li + 1] = qinf[1] | (u[1] << 16);
  }
  return 0;
}

// the MagSgn words of rows y and y + 1, a quad a lane, then the line state the next walk reads
__device__ void magsgn_rows(Block& B, int y) {
  const int nq = (B.w + 1) >> 1;
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int total = warp::scan(
        [&](int l) {  // the quad's MagSgn bits: U_q less its EMB bit, a significant sample
          if (q0 + l >= nq) return 0;
          const uint32_t qinf = B.qi[q0 + l] & 0xFFFF, u = B.qi[q0 + l] >> 16;
          int bits = 0;
          for (int n = 0; n < 4; ++n)
            if (qinf & (0x10u << n)) bits += (int)u - (int)((qinf >> (12 + n)) & 1);
          return bits;
        },
        [&](int l, int, int prefix) { B.offs[l] = prefix; });
    ring_fill(B.magsgn, B.ms_pos + total + 32);
    warp::each([&](int l) {
      const int q = q0 + l;
      if (q >= nq) return;
      const uint32_t qinf = B.qi[q] & 0xFFFF, u = B.qi[q] >> 16;
      int at = B.ms_pos + B.offs[l];
      uint8_t e_low[2] = {0, 0};
      for (int n = 0; n < 4; ++n) {
        if (!(qinf & (0x10u << n))) continue;
        const uint32_t ms = ring_bits(B.magsgn, at);
        const int m = (int)u - (int)((qinf >> (12 + n)) & 1);
        at += m;
        const uint32_t v = (ms & ((1u << m) - 1)) | (((qinf >> (8 + n)) & 1) << m) | 1;
        B.dat[(y + (n & 1)) * B.w + 2 * q + (n >> 1)] = ((ms & 1) << 31) | ((v + 2) << (B.p - 1));
        if (n & 1) e_low[n >> 1] = (uint8_t)(32 - warp::clz(v));
      }
      B.ecol[2 * q] = e_low[0];
      B.ecol[2 * q + 1] = e_low[1];
    });
    B.ms_pos += total;
  }
  warp::strided(B.w / 2 + 3, [&](int j) {
    const uint32_t a = j > 0 && 2 * j - 1 < B.w ? B.ecol[2 * j - 1] : 0, b = 2 * j < B.w ? B.ecol[2 * j] : 0;
    B.ls[j] = (a | b) ? 0x80 | (a > b ? a : b) : 0;
  });
}

// MagRef over the stripe of rows y0 .. y0 + 3, a column a lane
__device__ void magref_stripe(Block& B, int y0, const uint32_t* sig) {
  const uint32_t half = 1u << (B.p - 2);
  const auto nibble = [&](int c) { return c < B.w ? (sig[c >> 3] >> (4 * (c & 7))) & 15 : 0u; };
  for (int c0 = 0; c0 < B.w; c0 += 32) {
    const int total = warp::scan([&](int l) { return warp::popc(nibble(c0 + l)); },
                                 [&](int l, int, int prefix) { B.offs[l] = prefix; });
    ring_fill(B.magref, B.mr_pos + total + 32);
    warp::each([&](int l) {
      const uint32_t s = nibble(c0 + l);
      if (!s) return;
      uint32_t cwd = ring_bits(B.magref, B.mr_pos + B.offs[l]);
      for (int r = 0; r < 4; ++r)
        if (s >> r & 1) {
          uint32_t* at = &B.dat[(y0 + r) * B.w + c0 + l];
          *at = (*at ^ ((1u - (cwd & 1)) << (B.p - 1))) | half;
          cwd >>= 1;
        }
    });
    B.mr_pos += total;
  }
}

// a stripe's insignificant samples next to its significant ones, a word a lane
__device__ void membership(const Block& B, const uint32_t* sig, uint32_t* mbr) {
  warp::strided(B.nw, [&](int i) {
    uint32_t m = sig[i] | (i > 0 ? sig[i - 1] >> 28 : 0) | (sig[i] << 4) | (sig[i] >> 4) | (sig[i + 1] << 28);
    m |= ((m & 0x77777777u) << 1) | ((m & 0xEEEEEEEEu) >> 1);
    mbr[i] = m & ~sig[i];
  });
}

// SigProp over the stripe of rows y0 .. y0 + 3 (its words at index c, the next stripe's at 1 - c)
__device__ void sigprop_stripe(Block& B, int y0, int c, uint32_t pattern, bool with_next) {
  uint32_t *cur_sig = B.sigma[c], *cur_mbr = B.mbr[c], *nxt_sig = B.sigma[1 - c], *nxt_mbr = B.mbr[1 - c];
  if (with_next) {
    const bool causal = B.causal;
    warp::strided(B.nw, [&](int i) {
      const uint32_t t = nxt_sig[i] | (i > 0 ? nxt_sig[i - 1] >> 28 : 0) | (nxt_sig[i] << 4) | (nxt_sig[i] >> 4) |
                         (nxt_sig[i + 1] << 28);
      if (!causal) cur_mbr[i] |= (t & 0x11111111u) << 3;
      cur_mbr[i] &= ~cur_sig[i];
    });
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
                B.dat[(y0 + r) * B.w + i + j] |= ((cwd & 1) << 31) | val;
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
  warp::sync();
}

// one HT code block (desc row d) by the calling warp; -> an error code or 0
__device__ int decode_block(const uint8_t* __restrict__ data, const int* d, int* __restrict__ out, uint8_t* base,
                            int seg_cap, int dat_cap, int w_cap) {
  const int start = d[0], len1 = d[1], len2 = d[2], total = d[3], npasses = d[4], w = d[5], h = d[6];
  const int numbps = d[7], mb = d[8], sty = d[9], out_off = d[10], stride = d[11];
  const bool in_smem = total <= seg_cap;
  if (in_smem)  // the segments into shared memory while the lanes clear the rest
    warp::strided((total + 15) >> 4, [&](int t) { warp::copy16(base + 16 * t, data + start + 16 * t); });
  const uint8_t* buf = in_smem ? base : data + start;
  uint32_t* s = reinterpret_cast<uint32_t*>(base + seg_cap);
  Block B;
  B.w = w;
  B.h = h;
  B.p = numbps;
  B.nw = (w + 7) / 8;
  B.zero_p1 = (uint32_t)(mb + 2 - numbps);
  B.causal = (sty & kVsc) != 0;
  const int nw_cap = (w_cap + 7) / 8;
  B.dat = s;
  B.sigma[0] = s + dat_cap;
  B.sigma[1] = B.sigma[0] + (nw_cap + 2);
  B.mbr[0] = B.sigma[1] + (nw_cap + 2);
  B.mbr[1] = B.mbr[0] + (nw_cap + 2);
  B.ls = B.mbr[1] + (nw_cap + 2);
  B.qi = B.ls + (w_cap / 2 + 4);
  B.offs = reinterpret_cast<int*>(B.qi + (w_cap + 1) / 2 + 2);
  B.ecol = reinterpret_cast<uint8_t*>(B.offs + 32);
  uint32_t* rings = reinterpret_cast<uint32_t*>(B.offs + 32) + (w_cap + 2 + 3) / 4;
  warp::strided(w * h, [&](int t) { B.dat[t] = 0; });
  warp::strided(4 * (nw_cap + 2) + w_cap / 2 + 4, [&](int t) { B.sigma[0][t] = 0; });
  warp::copy_wait();

  const int lcup = len1;
  const int scup = ((int)buf[lcup - 1] << 4) + (buf[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079) return 1;
  if (!mel_init(B.mel, buf, lcup - scup, scup - 1)) return 2;
  rev_init_vlc(B.vlc, buf, lcup - 2, scup - 2);
  fwd_init(B.sigprop, buf, lcup, len2, 0u);
  ring_init(B.magsgn, buf, 0, lcup - scup, false, 0xFFu, rings);
  ring_init(B.magref, buf, lcup + len2 - 1, len2, true, 0u, rings + kRing);
  B.ms_pos = B.mr_pos = 0;
  B.run = mel_get_run(B.mel);
  int rc = walk(B, 0);
  if (rc) return rc;
  magsgn_rows(B, 0);
  for (int y = 2; y < h;) {
    rc = walk(B, y);
    if (rc) return rc;
    magsgn_rows(B, y);
    y += 2;
    if (npasses > 1 && (y & 3) == 0) {
      const int c = (y & 4) ? 1 : 0;  // the stripe that ended at y is at 1 - c, the one before at c
      if (npasses > 2) magref_stripe(B, y - 4, B.sigma[1 - c]);
      membership(B, B.sigma[1 - c], B.mbr[1 - c]);
      if (y >= 8) {
        sigprop_stripe(B, y - 8, c, kAll, true);
        uint32_t* done = B.sigma[c];
        warp::strided(B.nw + 2, [&](int i) { done[i] = 0; });
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
  warp::strided(w * h, [&](int t) {  // to the tile buffer, a row across the lanes, sign-magnitude to signed
    const int y = t / w, x = t - y * w;
    const uint32_t v = B.dat[t];
    const int32_t m = (int32_t)(v & 0x7FFFFFFFu);
    out[out_off + y * stride + x] = (v & 0x80000000u) ? -m : m;
  });
  return 0;
}

// shared bytes a warp: the segment buffer, then the state
int smem_bytes(int seg_cap, int dat_cap, int w_cap) {
  const int nw = (w_cap + 7) / 8;
  return seg_cap + 4 * (dat_cap + 4 * (nw + 2) + (w_cap / 2 + 4) + (w_cap + 1) / 2 + 2 + 32 + (w_cap + 2 + 3) / 4 +
                        2 * kRing);
}

#if defined(__CUDACC__)
__global__ void j2k_ht_kernel(const uint8_t* __restrict__ data, const int* __restrict__ desc, int nblocks,
                              int* __restrict__ out, int* next, int* __restrict__ errors, int seg_cap, int dat_cap,
                              int w_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  for (;;) {  // a persistent warp: the next block in the packed (heaviest first) order
    int b = 0;
    if (warp::lane() == 0) b = atomicAdd(next, 1);
    b = __shfl_sync(kAll, b, 0);
    if (b >= nblocks) return;
    const int rc = decode_block(data, desc + (size_t)b * kDescFields, out, smem, seg_cap, dat_cap, w_cap);
    if (rc && warp::lane() == 0) errors[b] = rc;
    __syncwarp();
  }
}
#endif

}  // namespace

#if defined(__CUDACC__)

// the two VLC tables (2 x 1024 uint16 on the host) into the current card's constant memory
extern "C" int j2k_ht_init(const void* tables) {
  return (int)cudaMemcpyToSymbol(kVlc, tables, sizeof(uint16_t) * 2 * 1024);
}

// one launch: `next` is an int of scratch (zeroed here, on the stream); seg_cap (a multiple of 16), dat_cap and
// w_cap size each warp's shared buffers for the largest block; -> a CUDA error or 0
extern "C" int j2k_ht_launch(const void* data, const void* desc, void* out, void* next, void* errors, int nblocks,
                             int seg_cap, int dat_cap, int w_cap, void* stream) {
  if (nblocks <= 0) return 0;
  const int smem = smem_bytes(seg_cap, dat_cap, w_cap);
  cudaError_t rc = cudaFuncSetAttribute(j2k_ht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, j2k_ht_kernel, 32, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = nblocks < per_sm * sms ? nblocks : per_sm * sms;
  rc = cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  j2k_ht_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>((const uint8_t*)data, (const int*)desc, nblocks,
                                                          (int*)out, (int*)next, (int*)errors, seg_cap, dat_cap,
                                                          w_cap);
  return (int)cudaGetLastError();
}

// for reports, at these buffer sizes: shared bytes a warp, resident warps a multiprocessor, registers a thread
extern "C" int j2k_ht_occupancy(int seg_cap, int dat_cap, int w_cap, int* smem, int* warps_per_sm, int* regs) {
  cudaFuncAttributes attr;
  *smem = smem_bytes(seg_cap, dat_cap, w_cap);
  cudaError_t rc = cudaFuncSetAttribute(j2k_ht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncGetAttributes(&attr, j2k_ht_kernel);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(warps_per_sm, j2k_ht_kernel, 32, *smem);
  *regs = attr.numRegs;
  return (int)rc;
}

#else

// host C++: the same decoder, one block after another, the warp emulated (see warp.cuh)
extern "C" int j2k_ht_init(const void* tables) {
  memcpy(kVlc, tables, sizeof(uint16_t) * 2 * 1024);
  return 0;
}

extern "C" int j2k_ht_emulate(const uint8_t* data, const int* desc, int nblocks, int* out, int* errors, int seg_cap,
                              int dat_cap, int w_cap) {
  uint8_t* base = new uint8_t[smem_bytes(seg_cap, dat_cap, w_cap) + 16];
  for (int b = 0; b < nblocks; ++b)
    errors[b] = decode_block(data, desc + (size_t)b * kDescFields, out, base, seg_cap, dat_cap, w_cap);
  delete[] base;
  return 0;
}

#endif
