// K5: JPEG 2000 tier-1 (EBCOT) decoding of every code block of one image.
//
// Original: OpenJPEG 2.5.4's `opj_t1_decode_cblks` (t1.c, mqc.c), host C
// reached through Pillow's Jpeg2KDecode.c; there is no TPU kernel behind
// it. It exists because tier-1 makes one MQ decision per coefficient, bit
// plane and pass: a Python tier-1 would take minutes for a letter page,
// while the code blocks (at most 64 x 64 coefficients) decode independently
// of each other from their own bytes.
//
// Design (first, simple and right): one thread per code block. Its
// neighbourhood flags live in a global scratch buffer ((w + 2) x (h + 2)
// words a block), its coefficients are written in place into the
// tile-component buffers, the MQ decoder's registers and the 19 context
// states sit in registers. The work is a serial chain of dependent
// decisions within each block, so the kernel is bound by latency and by
// the number of blocks in flight, not by bytes or by arithmetic: a letter
// page has a few thousand blocks, fewer than the card's threads. A warp a
// block with stripe-parallel scans and state in shared memory is the lever
// for later work.
//
// Output: int32 coefficients in OpenJPEG's t1 representation (bit plane b
// of the magnitude at bit b + 1, the next plane's half set), the ROI
// max-shift undone, bit for bit the plain version in
// utils/jpeg2000_t1.py::decode_block. No floating point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLazy = 0x01, kReset = 0x02, kVsc = 0x08, kSegsym = 0x20;
constexpr int kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;
constexpr int F_W = 1, F_E = 2, F_N = 4, F_S = 8, F_NW = 16, F_NE = 32, F_SW = 64, F_SE = 128;
constexpr int G_W = 256, G_E = 512, G_N = 1024, G_S = 2048;
constexpr int F_SIG = 4096, F_PI = 8192, F_MU = 16384, F_NEIGH = 0xFF;
constexpr int kDescFields = 12;

__constant__ uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
__constant__ uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                                  17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                                  33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
__constant__ uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                                  15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                  30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
__constant__ uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

struct Mq {
  const uint8_t* buf;  // the image's data; a segment is buf[bp, end), 0xFF past its end
  int bp, end;
  uint32_t a, c;
  int ct;
  uint8_t st[kNumCtx];
  uint8_t mps[kNumCtx];
};

__device__ __forceinline__ uint32_t byte_at(const Mq& m, int i) { return i < m.end ? m.buf[i] : 0xFFu; }

__device__ void reset_ctx(Mq& m) {
  for (int k = 0; k < kNumCtx; ++k) {
    m.st[k] = 0;
    m.mps[k] = 0;
  }
  m.st[kCtxUni] = 46;
  m.st[kCtxAgg] = 3;
  m.st[0] = 4;
}

__device__ __forceinline__ void bytein(Mq& m) {
  uint32_t nxt = byte_at(m, m.bp + 1);
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

__device__ int decode(Mq& m, int cx) {
  int s = m.st[cx];
  uint32_t qe = kQe[s];
  uint32_t a = m.a - qe;
  uint32_t c = m.c;
  int d;
  if ((c >> 16) < qe) {
    if (a < qe) {
      d = m.mps[cx];
      m.st[cx] = kNmps[s];
    } else {
      d = 1 - m.mps[cx];
      if (kSwitch[s]) m.mps[cx] = (uint8_t)d;
      m.st[cx] = kNlps[s];
    }
    a = qe;
  } else {
    c -= qe << 16;
    if (a & 0x8000u) {
      m.a = a;
      m.c = c;
      return m.mps[cx];
    }
    if (a < qe) {
      d = 1 - m.mps[cx];
      if (kSwitch[s]) m.mps[cx] = (uint8_t)d;
      m.st[cx] = kNlps[s];
    } else {
      d = m.mps[cx];
      m.st[cx] = kNmps[s];
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

// t1_init_ctxno_sc / t1_init_spb: the context in bits 0-4, the sign flip in bit 8
__device__ __forceinline__ int sc_ctx(int f) {
  int w = f & F_W ? (f & G_W ? -1 : 1) : 0;
  int e = f & F_E ? (f & G_E ? -1 : 1) : 0;
  int n = f & F_N ? (f & G_N ? -1 : 1) : 0;
  int s = f & F_S ? (f & G_S ? -1 : 1) : 0;
  int hc = max(-1, min(1, w + e));
  int vc = max(-1, min(1, n + s));
  int spb = (hc == 0 && vc == 0) ? 0 : !(hc > 0 || (hc == 0 && vc > 0));
  if (hc < 0) {
    hc = -hc;
    vc = -vc;
  }
  int k = hc == 0 ? (vc ? 1 : 0) : (vc == -1 ? 2 : vc == 0 ? 3 : 4);
  return (9 + k) | (spb << 8);
}

__device__ __forceinline__ void set_sig(int* flags, int fi, int neg, int ci, bool vsc, int W2) {
  flags[fi] |= F_SIG;
  flags[fi - 1] |= F_E | (neg ? G_E : 0);
  flags[fi + 1] |= F_W | (neg ? G_W : 0);
  if (!(ci == 0 && vsc)) {
    flags[fi - W2] |= F_S | (neg ? G_S : 0);
    flags[fi - W2 - 1] |= F_SE;
    flags[fi - W2 + 1] |= F_SW;
  }
  flags[fi + W2] |= F_N | (neg ? G_N : 0);
  flags[fi + W2 - 1] |= F_NE;
  flags[fi + W2 + 1] |= F_NW;
}

__device__ __forceinline__ int decode_sign(Mq& m, int f, bool raw) {
  if (raw) return raw_bit(m);
  int sc = sc_ctx(f);
  return decode(m, sc & 0xFF) ^ (sc >> 8);
}

__global__ void j2k_t1_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                              const int* __restrict__ desc, int nblocks, int* __restrict__ out,
                              int* __restrict__ scratch) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const int* d = desc + (size_t)b * kDescFields;
  const int data_off = d[0], seg_off = d[1], nsegs = d[2], w = d[3], h = d[4], orient = d[5];
  const int numbps = d[6], roishift = d[7], sty = d[8], out_off = d[9], stride = d[10], flags_off = d[11];
  if (w <= 0 || h <= 0 || nsegs == 0) return;
  const int W2 = w + 2;
  int* flags = scratch + flags_off;
  for (int i = 0; i < W2 * (h + 2); ++i) flags[i] = 0;
  int* dat = out + out_off;
  const bool vsc = sty & kVsc;

  Mq m;
  m.buf = data;
  reset_ctx(m);
  int bpno_plus_one = roishift + numbps;  // < 31, checked by the wrapper
  int passtype = 2;
  int pos = data_off;
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
        const int rows = min(4, h - k);
        for (int i = 0; i < w; ++i) {
          if (passtype == 0) {  // significance propagation
            for (int j = 0; j < rows; ++j) {
              const int fi = (k + j + 1) * W2 + i + 1;
              const int f = flags[fi];
              if ((f & (F_SIG | F_PI)) || !(f & F_NEIGH)) continue;
              const int v = raw ? raw_bit(m) : decode(m, zc_ctx(f, orient));
              if (v) {
                const int neg = decode_sign(m, f, raw);
                dat[(k + j) * stride + i] = neg ? -oph : oph;
                set_sig(flags, fi, neg, j, vsc, W2);
              }
              flags[fi] |= F_PI;
            }
          } else if (passtype == 1) {  // magnitude refinement
            for (int j = 0; j < rows; ++j) {
              const int fi = (k + j + 1) * W2 + i + 1;
              const int f = flags[fi];
              if ((f & (F_SIG | F_PI)) != F_SIG) continue;
              const int v = raw ? raw_bit(m) : decode(m, f & F_MU ? 16 : (f & F_NEIGH ? 15 : 14));
              int* x = &dat[(k + j) * stride + i];
              *x += (v ^ (*x < 0)) ? poshalf : -poshalf;
              flags[fi] |= F_MU;
            }
          } else {  // cleanup
            int start = 0;
            bool run = rows == 4;
            for (int j = 0; j < rows && run; ++j)
              if (flags[(k + j + 1) * W2 + i + 1] & (F_NEIGH | F_SIG | F_PI)) run = false;
            bool skip = false;
            if (run) {
              if (!decode(m, kCtxAgg)) {
                skip = true;
              } else {
                int r = decode(m, kCtxUni);
                r = (r << 1) | decode(m, kCtxUni);
                const int fi = (k + r + 1) * W2 + i + 1;
                const int neg = decode_sign(m, flags[fi], false);
                dat[(k + r) * stride + i] = neg ? -oph : oph;
                set_sig(flags, fi, neg, r, vsc, W2);
                start = r + 1;
              }
            }
            if (!skip) {
              for (int j = start; j < rows; ++j) {
                const int fi = (k + j + 1) * W2 + i + 1;
                const int f = flags[fi];
                if (start == 0 && (f & (F_SIG | F_PI))) continue;
                if (decode(m, zc_ctx(f, orient))) {
                  const int neg = decode_sign(m, flags[fi], false);
                  dat[(k + j) * stride + i] = neg ? -oph : oph;
                  set_sig(flags, fi, neg, j, vsc, W2);
                }
              }
            }
            for (int j = 0; j < rows; ++j) flags[(k + j + 1) * W2 + i + 1] &= ~F_PI;
          }
        }
      }
      if (passtype == 2 && (sty & kSegsym))
        for (int q = 0; q < 4; ++q) decode(m, kCtxUni);
      if ((sty & kReset) && !raw) reset_ctx(m);
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one -= 1;
      }
    }
  }
  if (roishift) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        int* v = &dat[y * stride + x];
        if (roishift >= 31) {
          *v = 0;
          continue;
        }
        const int mag = *v < 0 ? -*v : *v;
        if (mag >= (1 << roishift)) *v = *v < 0 ? -(mag >> roishift) : (mag >> roishift);
      }
  }
}

constexpr int kThreads = 64;

}  // namespace

extern "C" int j2k_t1_launch(const void* data, const void* segs, const void* desc, void* out, void* scratch,
                             int nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  const int grid = (nblocks + kThreads - 1) / kThreads;
  j2k_t1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)data, (const int*)segs,
                                                             (const int*)desc, nblocks, (int*)out,
                                                             (int*)scratch);
  return (int)cudaGetLastError();
}

// threads a block, resident blocks a multiprocessor, registers a thread (for reports)
extern "C" int j2k_t1_occupancy(int* threads, int* blocks_per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, j2k_t1_kernel);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, j2k_t1_kernel, kThreads, 0);
  *threads = kThreads;
  *regs = attr.numRegs;
  return (int)rc;
}
