// K5: JPEG 2000 tier-1 (EBCOT) decoding of every code block of one image.
//
// Original: OpenJPEG 2.5.4's `opj_t1_decode_cblks` (t1.c, mqc.c), host C
// reached through Pillow's Jpeg2KDecode.c; there is no TPU kernel behind
// it. It exists because tier-1 makes one MQ decision per coefficient, bit
// plane and pass: a Python tier-1 would take minutes for a letter page,
// while the code blocks (at most 64 x 64 coefficients) decode independently
// of each other from their own bytes.
//
// What bounds it: one serial chain of dependent MQ decisions a block (each
// decision's interval and context state feed the next), so neither bytes
// nor a peak arithmetic rate: no product is computed, and tensor cores,
// wgmma and fp8 have no part here. The time is the longest chain plus the
// decisions of the blocks that share its multiprocessor.
//
// Design: a warp a code block. Persistent warps (one a thread block, as
// many as the occupancy query keeps resident) take block indices from an
// atomic counter, in the order `pack_blocks` sorted them (heaviest first,
// so the longest chains start first). A block's state lives in the warp's
// shared memory: its segment bytes (copied in with cp.async while the lanes
// clear the rest; a block whose bytes exceed the buffer reads them from
// global memory), its flags packed to 16 bits over (w + 2) x (h + 2), its
// coefficients (w x h int32, written to the tile buffer once at the end,
// coalesced, with the ROI shift), the 19 context states (state << 1 | MPS)
// and this orientation's zero-coding and the sign-coding look-up tables.
// The MQ decoder is warp-uniform: A, C, CT and the byte pointer sit in
// registers and every lane runs the same decision on the same values, so no
// lane diverges. Only candidates are visited: for each 8-column piece of a
// stripe the lanes build, with one ballot, the mask of its samples the pass
// must decode (SPP: not significant, not visited, a significant neighbour;
// MRP: significant before this plane; cleanup: not significant and not
// visited, and the run-mode columns), and the serial walk steps from one
// to the next with ffs. Where a sample turns significant the masks are
// built again for the samples after it, so OpenJPEG's decision order holds
// exactly. Neighbour flags are set by nine lanes at once.
//
// Output: int32 coefficients in OpenJPEG's t1 representation (bit plane b
// of the magnitude at bit b + 1, the next plane's half set), the ROI
// max-shift undone, bit for bit the plain version in
// utils/jpeg2000_t1.py::decode_block. No floating point.

#include "warp.cuh"

namespace {

constexpr int kLazy = 0x01, kReset = 0x02, kVsc = 0x08, kSegsym = 0x20;
constexpr int kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;
// a sample's flags: its neighbours' significance (bits 0-7), the signs of the four direct ones (8-11: W E N S),
// its own state (12-14)
constexpr int F_W = 1, F_E = 2, F_N = 4, F_S = 8, F_NW = 16, F_NE = 32, F_SW = 64, F_SE = 128;
constexpr int F_SIG = 4096, F_PI = 8192, F_MU = 16384, F_NEIGH = 0xFF;
constexpr int kDescFields = 12;

// the MQ coder's states (ISO 15444-1 Table C.2) by 2 * state + MPS: Qe, and the next on MPS and on LPS
__constant__ uint16_t kQe[94] = {
    0x5601, 0x5601, 0x3401, 0x3401, 0x1801, 0x1801, 0x0AC1, 0x0AC1, 0x0521, 0x0521, 0x0221, 0x0221,
    0x5601, 0x5601, 0x5401, 0x5401, 0x4801, 0x4801, 0x3801, 0x3801, 0x3001, 0x3001, 0x2401, 0x2401,
    0x1C01, 0x1C01, 0x1601, 0x1601, 0x5601, 0x5601, 0x5401, 0x5401, 0x5101, 0x5101, 0x4801, 0x4801,
    0x3801, 0x3801, 0x3401, 0x3401, 0x3001, 0x3001, 0x2801, 0x2801, 0x2401, 0x2401, 0x2201, 0x2201,
    0x1C01, 0x1C01, 0x1801, 0x1801, 0x1601, 0x1601, 0x1401, 0x1401, 0x1201, 0x1201, 0x1101, 0x1101,
    0x0AC1, 0x0AC1, 0x09C1, 0x09C1, 0x08A1, 0x08A1, 0x0521, 0x0521, 0x0441, 0x0441, 0x02A1, 0x02A1,
    0x0221, 0x0221, 0x0141, 0x0141, 0x0111, 0x0111, 0x0085, 0x0085, 0x0049, 0x0049, 0x0025, 0x0025,
    0x0015, 0x0015, 0x0009, 0x0009, 0x0005, 0x0005, 0x0001, 0x0001, 0x5601, 0x5601};
__constant__ uint8_t kNmps[94] = {
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 76, 77, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 58, 59, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73,
    74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 90, 91, 92, 93};
__constant__ uint8_t kNlps[94] = {
    3,  2,  12, 13, 18, 19, 24, 25, 58, 59, 66, 67, 13, 12, 28, 29, 28, 29, 28, 29, 34, 35, 36, 37,
    40, 41, 42, 43, 29, 28, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 92, 93};

// the warp's shared memory, from a 16-byte aligned base: segment bytes, coefficients, tables, flags
struct Smem {
  uint8_t* seg;
  int* dat;
  uint32_t* ctx;  // 19 context states: Qe (bits 0-15) beside 2 * state + MPS (bits 16-22)
  uint8_t* cx;    // 32: each lane's sample's context in the pass, read ahead with the candidate masks
  uint8_t* zc;    // 256: the zero-coding context of this block's orientation by neighbourhood
  uint8_t* sc;    // 256: the sign-coding context (bits 0-4) and flip (bit 5)
  uint16_t* flags;
};

__device__ __forceinline__ Smem carve(uint8_t* base, int seg_cap, int dat_cap) {
  Smem s;
  s.seg = base;
  s.dat = reinterpret_cast<int*>(base + seg_cap);
  s.ctx = reinterpret_cast<uint32_t*>(base + seg_cap + 4 * dat_cap);
  s.cx = reinterpret_cast<uint8_t*>(s.ctx + 32);
  s.zc = s.cx + 32;
  s.sc = s.zc + 256;
  s.flags = reinterpret_cast<uint16_t*>(s.sc + 256);
  return s;
}

// t1_init_ctxno_zc: orientation 1 (HL) counts vertical neighbours as horizontal
__device__ __forceinline__ int zc_ctx(int f, int orient) {
  int h = (f & F_W ? 1 : 0) + (f & F_E ? 1 : 0);
  int v = (f & F_N ? 1 : 0) + (f & F_S ? 1 : 0);
  int d = (f & F_NW ? 1 : 0) + (f & F_NE ? 1 : 0) + (f & F_SW ? 1 : 0) + (f & F_SE ? 1 : 0);
  if (orient == 1) {
    int t = h;
    h = v;
    v = t;
  }
  if (orient < 3) {
    if (h == 0) return v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : (v == 1 ? 3 : 4);
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
  }
  int hv = h + v;
  if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
  if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
  if (d == 2) return hv == 0 ? 6 : 7;
  return 8;
}

// t1_init_ctxno_sc / t1_init_spb by the four direct neighbours' significance (bits 0-3) and signs (4-7):
// the context in bits 0-4, the sign flip in bit 5
__device__ __forceinline__ int sc_entry(int i) {
  const int w = i & 1 ? (i & 16 ? -1 : 1) : 0;
  const int e = i & 2 ? (i & 32 ? -1 : 1) : 0;
  const int n = i & 4 ? (i & 64 ? -1 : 1) : 0;
  const int s = i & 8 ? (i & 128 ? -1 : 1) : 0;
  int hc = w + e < -1 ? -1 : w + e > 1 ? 1 : w + e;
  int vc = n + s < -1 ? -1 : n + s > 1 ? 1 : n + s;
  const int spb = (hc == 0 && vc == 0) ? 0 : !(hc > 0 || (hc == 0 && vc > 0));
  if (hc < 0) {
    hc = -hc;
    vc = -vc;
  }
  const int k = hc == 0 ? (vc ? 1 : 0) : (vc == -1 ? 2 : vc == 0 ? 3 : 4);
  return (9 + k) | (spb << 5);
}

struct Mq {
  const uint8_t* buf;  // the block's bytes; a segment is buf[bp, end), 0xFF past its end
  int bp, end;
  uint32_t a, c;
  int ct;
};

__device__ __forceinline__ uint32_t byte_at(const Mq& m, int i) { return i < m.end ? m.buf[i] : 0xFFu; }

__device__ __forceinline__ void bytein(Mq& m) {
  const uint32_t nxt = byte_at(m, m.bp + 1);
  if (byte_at(m, m.bp) == 0xFFu) {
    if (nxt > 0x8Fu) {
      m.c += 0xFF00u;
      m.ct = 8;
    } else {
      m.bp += 1;
      m.c += nxt << 9;
      m.ct = 7;
    }
  } else {
    m.bp += 1;
    m.c += nxt << 8;
    m.ct = 8;
  }
}

__device__ void init_mq(Mq& m, int bp, int end) {
  m.bp = bp;
  m.end = end;
  m.c = byte_at(m, bp) << 16;
  bytein(m);
  m.c <<= 7;
  m.ct -= 7;
  m.a = 0x8000u;
}

__device__ void init_raw(Mq& m, int bp, int end) {
  m.bp = bp;
  m.end = end;
  m.c = 0;
  m.ct = 0;
}

// a context's state word: its Qe beside 2 * state + MPS, so a decision waits on one read
__device__ __forceinline__ uint32_t state_word(int s) { return kQe[s] | ((uint32_t)s << 16); }

// one MQ decision in context cx; its state in shared memory, written alike by every lane
__device__ __forceinline__ int decode(Mq& m, uint32_t* ctx, int cx) {
  const uint32_t word = ctx[cx];
  const uint32_t qe = word & 0xFFFFu;
  const int s = (int)(word >> 16);
  const int mps = s & 1;
  uint32_t a = m.a - qe;
  uint32_t c = m.c;
  int d;
  if ((c >> 16) < qe) {
    if (a < qe) {
      d = mps;
      ctx[cx] = state_word(kNmps[s]);
    } else {
      d = 1 - mps;
      ctx[cx] = state_word(kNlps[s]);
    }
    a = qe;
  } else {
    c -= qe << 16;
    if (a & 0x8000u) {
      m.a = a;
      m.c = c;
      return mps;
    }
    if (a < qe) {
      d = 1 - mps;
      ctx[cx] = state_word(kNlps[s]);
    } else {
      d = mps;
      ctx[cx] = state_word(kNmps[s]);
    }
  }
  do {
    if (m.ct == 0) {
      m.c = c;
      bytein(m);
      c = m.c;
    }
    a <<= 1;
    c <<= 1;
    m.ct -= 1;
  } while (a < 0x8000u);
  m.a = a;
  m.c = c;
  return d;
}

__device__ int raw_bit(Mq& m) {
  if (m.ct == 0) {
    if (m.c == 0xFFu) {
      if (byte_at(m, m.bp) > 0x8Fu) {
        m.c = 0xFFu;
        m.ct = 8;
      } else {
        m.c = byte_at(m, m.bp);
        m.bp += 1;
        m.ct = 7;
      }
    } else {
      m.c = byte_at(m, m.bp);
      m.bp += 1;
      m.ct = 8;
    }
  }
  m.ct -= 1;
  return (m.c >> m.ct) & 1;
}

__device__ void reset_ctx(uint32_t* ctx) {
  warp::each([&](int l) {
    if (l < kNumCtx) ctx[l] = state_word(l == kCtxUni ? 2 * 46 : l == kCtxAgg ? 2 * 3 : l == 0 ? 2 * 4 : 0);
  });
}

// the sample at flag index fi (row ci of its stripe) turns significant: nine lanes set its flag and its
// neighbours' (lane 3r + c: r the row, this / above / below, c the column, this / west / east)
__device__ __forceinline__ void set_sig(uint16_t* flags, int fi, int neg, int ci, bool vsc, int W2) {
  warp::each([&](int l) {
    if (l >= 9) return;
    const int r = l / 3, c = l - 3 * r;
    if (r == 1 && ci == 0 && vsc) return;
    // the flag bit each of the nine gets (4 bits a lane): SIG, E, W, S, SE, SW, N, NE, NW
    const int bit = (int)((0x45267301Cull >> (4 * l)) & 15);
    const int sign = (l == 1 || l == 2 || l == 3 || l == 6) && neg ? 1 << (bit + 8) : 0;
    const int at = fi + (r == 0 ? 0 : r == 1 ? -W2 : W2) + (c == 0 ? 0 : c == 1 ? -1 : 1);
    flags[at] |= (uint16_t)((1 << bit) | sign);
  });
}

__device__ __forceinline__ int decode_sign(Mq& m, const Smem& S, int f, bool raw) {
  if (raw) return raw_bit(m);
  const int sc = S.sc[(f & 15) | ((f >> 4) & 0xF0)];
  return decode(m, S.ctx, sc & 31) ^ (sc >> 5);
}

// one code block (desc row d) by the calling warp, its state in S
__device__ void decode_block(const uint8_t* __restrict__ data, const int* __restrict__ segs, const int* d,
                             int* __restrict__ out, uint8_t* base, int seg_cap, int dat_cap) {
  const int data_off = d[0], seg_off = d[1], nsegs = d[2], w = d[3], h = d[4], orient = d[5];
  const int numbps = d[6], roishift = d[7], sty = d[8], out_off = d[9], stride = d[10], nbytes = d[11];
  if (w <= 0 || h <= 0 || nsegs == 0) return;
  const Smem S = carve(base, seg_cap, dat_cap);
  const int W2 = w + 2;
  const bool vsc = sty & kVsc;
  const bool in_smem = nbytes <= seg_cap;
  if (in_smem) {  // the segments into shared memory while the lanes clear the rest
    warp::strided((nbytes + 15) >> 4, [&](int t) { warp::copy16(S.seg + 16 * t, data + data_off + 16 * t); });
  }
  warp::strided(W2 * (h + 2), [&](int t) { S.flags[t] = 0; });
  warp::strided(w * h, [&](int t) { S.dat[t] = 0; });
  warp::strided(256, [&](int t) {
    S.zc[t] = (uint8_t)zc_ctx(t, orient);
    S.sc[t] = (uint8_t)sc_entry(t);
  });
  reset_ctx(S.ctx);
  warp::copy_wait();

  Mq m;
  m.buf = in_smem ? S.seg : data + data_off;
  int bpno_plus_one = roishift + numbps;  // < 31, checked by the wrapper
  int passtype = 2;
  int pos = 0;
  for (int sg = 0; sg < nsegs; ++sg) {
    const int seglen = segs[2 * (seg_off + sg)], npasses = segs[2 * (seg_off + sg) + 1];
    const bool raw = (bpno_plus_one <= numbps - 4) && passtype < 2 && (sty & kLazy);
    if (raw)
      init_raw(m, pos, pos + seglen);
    else
      init_mq(m, pos, pos + seglen);
    pos += seglen;
    for (int p = 0; p < npasses && bpno_plus_one >= 1; ++p) {
      const int one = 1 << bpno_plus_one;
      const int oph = one | (one >> 1);
      const int poshalf = one >> 1;
      for (int k = 0; k < h; k += 4) {
        const int rows = h - k < 4 ? h - k : 4;
        // an 8-column piece of the stripe at a time: lane l is its sample (column l / 4, row l % 4)
        for (int c0 = 0; c0 < w; c0 += 8) {
          const auto flag_at = [&](int l) { return (k + (l & 3) + 1) * W2 + c0 + (l >> 2) + 1; };
          const auto valid = [&](int l) { return c0 + (l >> 2) < w && (l & 3) < rows; };
          if (passtype == 0) {  // significance propagation
            const auto cand = [&](int l) {  // and each lane's zero-coding context, read ahead
              if (!valid(l)) return false;
              const int f = S.flags[flag_at(l)];
              S.cx[l] = S.zc[f & 0xFF];
              return !(f & (F_SIG | F_PI)) && (f & F_NEIGH);
            };
            uint32_t todo = warp::ballot(cand);
            warp::sync();
            while (todo) {
              const int l = warp::ffs(todo) - 1;
              todo &= todo - 1;
              const int fi = flag_at(l), j = l & 3;
              const int v = raw ? raw_bit(m) : decode(m, S.ctx, S.cx[l]);
              if (v) {
                const int neg = decode_sign(m, S, S.flags[fi], raw);
                S.dat[(k + j) * w + c0 + (l >> 2)] = neg ? -oph : oph;
                set_sig(S.flags, fi, neg, j, vsc, W2);
                todo = l == 31 ? 0 : warp::ballot(cand) & (warp::kAll << (l + 1));  // later samples may join
                warp::sync();
              }
              S.flags[fi] |= F_PI;
            }
          } else if (passtype == 1) {  // magnitude refinement
            const uint32_t cand = warp::ballot([&](int l) {  // and each lane's refinement context
              if (!valid(l)) return false;
              const int f = S.flags[flag_at(l)];
              S.cx[l] = f & F_MU ? 16 : (f & F_NEIGH ? 15 : 14);
              return (f & (F_SIG | F_PI)) == F_SIG;
            });
            warp::sync();
            for (uint32_t todo = cand; todo; todo &= todo - 1) {
              const int l = warp::ffs(todo) - 1;
              const int v = raw ? raw_bit(m) : decode(m, S.ctx, S.cx[l]);
              int* x = &S.dat[(k + (l & 3)) * w + c0 + (l >> 2)];
              *x += (v ^ (*x < 0)) ? poshalf : -poshalf;
            }
            warp::each([&](int l) {
              if (cand >> l & 1) S.flags[flag_at(l)] |= F_MU;
            });
          } else {  // cleanup
            const uint32_t open = warp::ballot([&](int l) {  // not significant, not visited by SPP
              return valid(l) && !(S.flags[flag_at(l)] & (F_SIG | F_PI));
            });
            const auto quiet = [&](int l) {  // none of (neighbours, significant, visited): run mode if all
              if (!valid(l)) return false;    // four; and each lane's zero-coding context, read ahead
              const int f = S.flags[flag_at(l)];
              S.cx[l] = S.zc[f & 0xFF];
              return !(f & (F_NEIGH | F_SIG | F_PI));
            };
            const auto look = [&]() {  // after a sample turns significant too: its later neighbours changed
              const uint32_t q = warp::ballot(quiet);
              warp::sync();
              return rows == 4 ? q : 0u;
            };
            uint32_t run = look();
            const int ncols = w - c0 < 8 ? w - c0 : 8;
            for (int i = 0; i < ncols; ++i) {
              uint32_t todo = (open >> (4 * i)) & 15;
              if (((run >> (4 * i)) & 15) == 15) {
                if (!decode(m, S.ctx, kCtxAgg)) continue;
                int r = decode(m, S.ctx, kCtxUni);
                r = (r << 1) | decode(m, S.ctx, kCtxUni);
                const int fi = flag_at(4 * i + r);
                const int neg = decode_sign(m, S, S.flags[fi], false);
                S.dat[(k + r) * w + c0 + i] = neg ? -oph : oph;
                set_sig(S.flags, fi, neg, r, vsc, W2);
                run = look();
                todo = 15u & (15u << (r + 1));
              }
              while (todo) {
                const int j = warp::ffs(todo) - 1;
                todo &= todo - 1;
                const int fi = flag_at(4 * i + j);
                if (decode(m, S.ctx, S.cx[4 * i + j])) {
                  const int neg = decode_sign(m, S, S.flags[fi], false);
                  S.dat[(k + j) * w + c0 + i] = neg ? -oph : oph;
                  set_sig(S.flags, fi, neg, j, vsc, W2);
                  run = look();
                }
              }
            }
            warp::each([&](int l) {  // the piece's SPP marks are spent
              if (valid(l)) S.flags[flag_at(l)] &= (uint16_t)~F_PI;
            });
          }
        }
      }
      if (passtype == 2 && (sty & kSegsym))
        for (int q = 0; q < 4; ++q) decode(m, S.ctx, kCtxUni);
      if ((sty & kReset) && !raw) reset_ctx(S.ctx);
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one -= 1;
      }
      warp::sync();
    }
  }
  warp::strided(w * h, [&](int t) {  // to the tile buffer, a row across the lanes, the ROI shift undone
    const int y = t / w, x = t - y * w;
    int v = S.dat[t];
    if (roishift) {
      const int mag = v < 0 ? -v : v;
      if (roishift >= 31)
        v = 0;
      else if (mag >= (1 << roishift))
        v = v < 0 ? -(mag >> roishift) : (mag >> roishift);
    }
    out[out_off + y * stride + x] = v;
  });
}

// shared bytes a warp: segment buffer, coefficients, context words, read-ahead contexts, 2 x 256 bytes of
// tables, flags
int smem_bytes(int seg_cap, int dat_cap, int flags_cap) {
  return seg_cap + 4 * dat_cap + 128 + 32 + 512 + 2 * flags_cap;
}

#if defined(__CUDACC__)
__global__ void j2k_t1_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                              const int* __restrict__ desc, int nblocks, int* __restrict__ out, int* next,
                              int seg_cap, int dat_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  for (;;) {  // a persistent warp: the next block in the packed (heaviest first) order
    int b = 0;
    if (warp::lane() == 0) b = atomicAdd(next, 1);
    b = __shfl_sync(warp::kAll, b, 0);
    if (b >= nblocks) return;
    decode_block(data, segs, desc + (size_t)b * kDescFields, out, smem, seg_cap, dat_cap);
    __syncwarp();
  }
}
#endif

}  // namespace

#if defined(__CUDACC__)

// one launch: `next` is an int of scratch (zeroed here, on the stream); seg_cap (a multiple of 16), dat_cap and
// flags_cap size each warp's shared buffers for the largest block; -> a CUDA error or 0
extern "C" int j2k_t1_launch(const void* data, const void* segs, const void* desc, void* out, void* next,
                             int nblocks, int seg_cap, int dat_cap, int flags_cap, void* stream) {
  if (nblocks <= 0) return 0;
  const int smem = smem_bytes(seg_cap, dat_cap, flags_cap);
  cudaError_t rc = cudaFuncSetAttribute(j2k_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, j2k_t1_kernel, 32, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = nblocks < per_sm * sms ? nblocks : per_sm * sms;
  rc = cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  j2k_t1_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>((const uint8_t*)data, (const int*)segs,
                                                          (const int*)desc, nblocks, (int*)out, (int*)next,
                                                          seg_cap, dat_cap);
  return (int)cudaGetLastError();
}

// for reports, at these buffer sizes: shared bytes a warp, resident warps a multiprocessor, registers a thread
extern "C" int j2k_t1_occupancy(int seg_cap, int dat_cap, int flags_cap, int* smem, int* warps_per_sm, int* regs) {
  cudaFuncAttributes attr;
  *smem = smem_bytes(seg_cap, dat_cap, flags_cap);
  cudaError_t rc = cudaFuncSetAttribute(j2k_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncGetAttributes(&attr, j2k_t1_kernel);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(warps_per_sm, j2k_t1_kernel, 32, *smem);
  *regs = attr.numRegs;
  return (int)rc;
}

#else

// host C++: the same decoder, one block after another, the warp emulated (see warp.cuh)
extern "C" int j2k_t1_emulate(const uint8_t* data, const int* segs, const int* desc, int nblocks, int* out,
                              int seg_cap, int dat_cap, int flags_cap) {
  uint8_t* base = new uint8_t[smem_bytes(seg_cap, dat_cap, flags_cap) + 16];
  for (int b = 0; b < nblocks; ++b) decode_block(data, segs, desc + (size_t)b * kDescFields, out, base, seg_cap, dat_cap);
  delete[] base;
  return 0;
}

#endif
