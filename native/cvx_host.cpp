// cvx_host: native host-side runtime for cvxcompress_tpu.
//
// A from-scratch C++ implementation of the codec's host responsibilities:
//   * the reference-compatible C ABI (cvx_compress / cvx_decompress_* /
//     *_th variants, mirroring /root/reference/CvxCompress.hxx:139-192) so
//     existing FFI consumers (e.g. the Julia wrapper ecosystem) can switch,
//   * a fast multi-threaded entropy decoder/encoder used by the Python
//     package for host-side stream handling around the device compute path,
//   * a complete standalone CPU codec (scalar wavelet + entropy stage)
//     for environments without an accelerator.
//
// Semantics contracts implemented here (written fresh from the format spec,
// not translated):
//   wavelet: Antonini 7/9, chained symmetric mirrors, level schedule
//            n -> n-n/2 (reference Wavelet_Transform_Slow.cpp:21-30,59-67,80)
//   quantizer: i = trunc(mulfac*c) with x86 cvttss2si semantics
//            (Run_Length_Encode_Slow.cpp:203-207)
//   grammar: escape codes of Run_Length_Escape_Codes.hxx:8-14 including the
//            group-of-8 fast paths and their size guards (:216,:231,:246)
//   container: header/offset-table/payload (CvxCompress.cpp:284-316,421-422)
//
// Zero runs >= 2^24 are split across tokens (deliberate fix of the
// reference's 24-bit run truncation; only reachable for all-zero 256^3).

#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using std::int32_t;
using std::int64_t;
using std::uint32_t;
using std::uint8_t;

// ---------------------------------------------------------------- wavelet

constexpr float AL[5] = {8.526986790094000e-001f, 3.774028556126500e-001f,
                         -1.106244044184200e-001f, -2.384946501938001e-002f,
                         3.782845550699501e-002f};
constexpr float AH[4] = {7.884856164056601e-001f, -4.180922732222101e-001f,
                         -4.068941760955800e-002f, 6.453888262893799e-002f};
constexpr float SL[4] = {7.884856164056601e-001f, 4.180922732222101e-001f,
                         -4.068941760955800e-002f, -6.453888262893799e-002f};
constexpr float SH[5] = {8.526986790094000e-001f, -3.774028556126500e-001f,
                         -1.106244044184200e-001f, 2.384946501938001e-002f,
                         3.782845550699501e-002f};

inline int mirr(int v, int n) {
  v = v < 0 ? -v : v;
  v = v >= n ? 2 * n - 2 - v : v;
  v = v < 0 ? -v : v;
  return v >= n ? 2 * n - 2 - v : v;
}
inline int mirr_sl(int v, int nl) {
  for (int r = 0; r < 3; ++r) {
    v = v < 0 ? -v : v;
    v = v >= nl ? 2 * nl - 1 - v : v;
  }
  return v;
}
inline int mirr_sh(int v, int nl, int nh) {
  v -= nl;
  for (int r = 0; r < 3; ++r) {
    v = v < 0 ? -v - 1 : v;
    v = v >= nh ? 2 * nh - 2 - v : v;
  }
  return nl + v;
}

// one full multi-level forward transform along a strided axis
void wav_fwd_axis(float* p, float* tmp, int stride, int dim) {
  for (int n = dim; n >= 2; n -= n / 2) {
    for (int i = 0; i < n; ++i) tmp[i] = p[i * stride];
    const int nh = n / 2, nl = n - nh;
    for (int ix = 0; ix < nl; ++ix) {
      const int i0 = 2 * ix;
      float a = AL[4] * (tmp[mirr(i0 - 4, n)] + tmp[mirr(i0 + 4, n)]);
      a += AL[1] * (tmp[mirr(i0 - 1, n)] + tmp[mirr(i0 + 1, n)]);
      a += AL[0] * tmp[i0];
      float b = AL[3] * (tmp[mirr(i0 - 3, n)] + tmp[mirr(i0 + 3, n)]);
      b += AL[2] * (tmp[mirr(i0 - 2, n)] + tmp[mirr(i0 + 2, n)]);
      p[ix * stride] = a + b;
    }
    for (int ix = 0; ix < nh; ++ix) {
      const int i0 = 2 * ix + 1;
      float a = AH[3] * (tmp[mirr(i0 - 3, n)] + tmp[mirr(i0 + 3, n)]);
      a += AH[0] * tmp[i0];
      float b = AH[2] * (tmp[mirr(i0 - 2, n)] + tmp[mirr(i0 + 2, n)]);
      b += AH[1] * (tmp[mirr(i0 - 1, n)] + tmp[mirr(i0 + 1, n)]);
      p[(nl + ix) * stride] = a + b;
    }
  }
}

void wav_inv_axis(float* p, float* tmp, int stride, int dim) {
  int lv[32], nlv = 0;
  for (int n = dim; n >= 2; n -= n / 2) lv[nlv++] = n;
  for (int li = nlv - 1; li >= 0; --li) {
    const int n = lv[li];
    for (int i = 0; i < n; ++i) tmp[i] = p[i * stride];
    const int nh = n / 2, nl = n - nh;
    for (int k = 0; k < nl; ++k) {
      float v = SL[0] * tmp[k];
      v += SL[2] * (tmp[mirr_sl(k - 1, nl)] + tmp[mirr_sl(k + 1, nl)]);
      v += SH[1] * (tmp[mirr_sh(nl + k - 1, nl, nh)] + tmp[mirr_sh(nl + k, nl, nh)]);
      v += SH[3] * (tmp[mirr_sh(nl + k - 2, nl, nh)] + tmp[mirr_sh(nl + k + 1, nl, nh)]);
      p[2 * k * stride] = v;
    }
    for (int k = 0; k < nh; ++k) {
      float v = SL[1] * (tmp[mirr_sl(k, nl)] + tmp[mirr_sl(k + 1, nl)]);
      v += SL[3] * (tmp[mirr_sl(k - 1, nl)] + tmp[mirr_sl(k + 2, nl)]);
      v += SH[0] * tmp[nl + k];
      v += SH[2] * (tmp[mirr_sh(nl + k - 1, nl, nh)] + tmp[mirr_sh(nl + k + 1, nl, nh)]);
      v += SH[4] * (tmp[mirr_sh(nl + k - 2, nl, nh)] + tmp[mirr_sh(nl + k + 2, nl, nh)]);
      p[(2 * k + 1) * stride] = v;
    }
  }
}

// ---- bit-parity variants ----------------------------------------------
// Replicate the accumulation order of the reference's GENERATED plain-AVX
// kernels (the deployed fast path): forward = al4-pair, al3, al2, al1,
// al0-center (Wavelet_Transform_Slow.cpp:398-448, non-avx2 branch:
// mul+add, no FMA); inverse even = sh3-pair, sl2, sh1, sl0-center; odd =
// sh4-pair, sl3, sh2, sl1, sh0-center (:588-696).  With -ffp-contract=off
// on both builds, decompressed floats are bit-identical to the
// reference's plain-AVX (-mavx, no FMA) build — the AVX2+FMA build of the
// reference differs from its own plain build, so parity is pinned to the
// latter (see BASELINE.md).

void wav_fwd_axis_parity(float* p, float* tmp, int stride, int dim) {
  for (int n = dim; n >= 2; n -= n / 2) {
    for (int i = 0; i < n; ++i) tmp[i] = p[i * stride];
    const int nh = n / 2, nl = n - nh;
    for (int ix = 0; ix < nl; ++ix) {
      const int i0 = 2 * ix;
      float acc = AL[4] * (tmp[mirr(i0 - 4, n)] + tmp[mirr(i0 + 4, n)]);
      acc = acc + AL[3] * (tmp[mirr(i0 - 3, n)] + tmp[mirr(i0 + 3, n)]);
      acc = acc + AL[2] * (tmp[mirr(i0 - 2, n)] + tmp[mirr(i0 + 2, n)]);
      acc = acc + AL[1] * (tmp[mirr(i0 - 1, n)] + tmp[mirr(i0 + 1, n)]);
      acc = acc + AL[0] * tmp[i0];
      p[ix * stride] = acc;
    }
    for (int ix = 0; ix < nh; ++ix) {
      const int i0 = 2 * ix + 1;
      float acc = AH[3] * (tmp[mirr(i0 - 3, n)] + tmp[mirr(i0 + 3, n)]);
      acc = acc + AH[2] * (tmp[mirr(i0 - 2, n)] + tmp[mirr(i0 + 2, n)]);
      acc = acc + AH[1] * (tmp[mirr(i0 - 1, n)] + tmp[mirr(i0 + 1, n)]);
      acc = acc + AH[0] * tmp[i0];
      p[(nl + ix) * stride] = acc;
    }
  }
}

void wav_inv_axis_parity(float* p, float* tmp, int stride, int dim) {
  int lv[32], nlv = 0;
  for (int n = dim; n >= 2; n -= n / 2) lv[nlv++] = n;
  for (int li = nlv - 1; li >= 0; --li) {
    const int n = lv[li];
    for (int i = 0; i < n; ++i) tmp[i] = p[i * stride];
    const int nh = n / 2, nl = n - nh;
    for (int k = 0; k < nl; ++k) {
      float acc = SH[3] * (tmp[mirr_sh(nl + k - 2, nl, nh)] +
                           tmp[mirr_sh(nl + k + 1, nl, nh)]);
      acc = acc + SL[2] * (tmp[mirr_sl(k - 1, nl)] + tmp[mirr_sl(k + 1, nl)]);
      acc = acc + SH[1] * (tmp[mirr_sh(nl + k - 1, nl, nh)] +
                           tmp[mirr_sh(nl + k, nl, nh)]);
      acc = acc + SL[0] * tmp[k];
      p[2 * k * stride] = acc;
    }
    for (int k = 0; k < nh; ++k) {
      float acc = SH[4] * (tmp[mirr_sh(nl + k - 2, nl, nh)] +
                           tmp[mirr_sh(nl + k + 2, nl, nh)]);
      acc = acc + SL[3] * (tmp[mirr_sl(k - 1, nl)] + tmp[mirr_sl(k + 2, nl)]);
      acc = acc + SH[2] * (tmp[mirr_sh(nl + k - 1, nl, nh)] +
                           tmp[mirr_sh(nl + k + 1, nl, nh)]);
      acc = acc + SL[1] * (tmp[mirr_sl(k, nl)] + tmp[mirr_sl(k + 1, nl)]);
      acc = acc + SH[0] * tmp[nl + k];
      p[(2 * k + 1) * stride] = acc;
    }
  }
}

// block is contiguous (bz, by, bx); axis order x -> y -> z both directions
typedef void (*axis_fn)(float*, float*, int, int);

void wav_fwd_block_ex(float* blk, float* tmp, int bx, int by, int bz,
                      bool parity) {
  const axis_fn f = parity ? wav_fwd_axis_parity : wav_fwd_axis;
  if (bx > 1)
    for (int zy = 0; zy < bz * by; ++zy) f(blk + zy * bx, tmp, 1, bx);
  if (by > 1)
    for (int z = 0; z < bz; ++z)
      for (int x = 0; x < bx; ++x)
        f(blk + z * by * bx + x, tmp, bx, by);
  if (bz > 1)
    for (int yx = 0; yx < by * bx; ++yx)
      f(blk + yx, tmp, by * bx, bz);
}
void wav_inv_block_ex(float* blk, float* tmp, int bx, int by, int bz,
                      bool parity) {
  const axis_fn f = parity ? wav_inv_axis_parity : wav_inv_axis;
  if (bx > 1)
    for (int zy = 0; zy < bz * by; ++zy) f(blk + zy * bx, tmp, 1, bx);
  if (by > 1)
    for (int z = 0; z < bz; ++z)
      for (int x = 0; x < bx; ++x)
        f(blk + z * by * bx + x, tmp, bx, by);
  if (bz > 1)
    for (int yx = 0; yx < by * bx; ++yx)
      f(blk + yx, tmp, by * bx, bz);
}
void wav_fwd_block(float* blk, float* tmp, int bx, int by, int bz) {
  wav_fwd_block_ex(blk, tmp, bx, by, bz, false);
}
void wav_inv_block(float* blk, float* tmp, int bx, int by, int bz) {
  wav_inv_block_ex(blk, tmp, bx, by, bz, false);
}

// ----------------------------------------------------------- entropy stage

constexpr int64_t MAX_RUN24 = (1 << 24) - 1;
constexpr uint8_t B_RLESC1 = 0x7F, B_RLESC3 = 0x7D, B_VLESC2 = 0x83,
                  B_VLESC3 = 0x81, B_VLESC4 = 0x80, B_VLESC2_8X = 0x82,
                  B_VLESC3_8X = 0x7E;

inline void flush_run(uint8_t*& d, int64_t& run) {
  while (run > MAX_RUN24) {
    *d++ = B_RLESC3;
    *d++ = 0xFF; *d++ = 0xFF; *d++ = 0xFF;
    run -= MAX_RUN24;
  }
  if (run == 0) return;
  if (run == 1) {
    *d++ = 0;
  } else if (run < 256) {
    *d++ = B_RLESC1;
    *d++ = (uint8_t)run;
  } else {
    *d++ = B_RLESC3;
    *d++ = (uint8_t)run; *d++ = (uint8_t)(run >> 8); *d++ = (uint8_t)(run >> 16);
  }
  run = 0;
}

inline int32_t cvtt(float f) {
  // x86 cvttss2si semantics: trunc toward zero, INT32_MIN on overflow/NaN
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return INT32_MIN;
  return (int32_t)f;
}

// encode one block; returns stream size in bytes. out must hold >= 5*cells+8.
int64_t rle_encode_block(float mulfac, const float* vals, int64_t cells,
                         uint8_t* out) {
  uint8_t* d = out;
  int64_t run = 0;
  for (int64_t i = 0; i < cells; i += 8) {
    float fv[8];
    int32_t iv[8];
    int zeros = 0, nb = 0, ns = 0, n3 = 0;
    for (int l = 0; l < 8; ++l) {
      fv[l] = mulfac * vals[i + l];
      iv[l] = cvtt(fv[l]);
      zeros += iv[l] == 0;
      nb += iv[l] > -125 && iv[l] < 125;
      ns += iv[l] >= -32768 && iv[l] <= 32767;
      n3 += iv[l] >= -8388608 && iv[l] <= 8388607;
    }
    if (zeros == 8) {  // whole group extends the run
      run += 8;
      continue;
    }
    if (zeros == 0 && nb == 8) {  // 8 plain bytes
      flush_run(d, run);
      for (int l = 0; l < 8; ++l) *d++ = (uint8_t)iv[l];
      continue;
    }
    if (zeros == 0 && ns == 8 && nb + (8 - nb) * 3 > 17) {  // VLESC2_8x
      flush_run(d, run);
      *d++ = B_VLESC2_8X;
      for (int l = 0; l < 8; ++l) {
        *d++ = (uint8_t)iv[l]; *d++ = (uint8_t)(iv[l] >> 8);
      }
      continue;
    }
    if (zeros == 0 && n3 == 8 &&
        nb + (ns - nb) * 3 + (8 - ns) * 4 > 25) {  // VLESC3_8x
      flush_run(d, run);
      *d++ = B_VLESC3_8X;
      for (int l = 0; l < 8; ++l) {
        *d++ = (uint8_t)iv[l]; *d++ = (uint8_t)(iv[l] >> 8);
        *d++ = (uint8_t)(iv[l] >> 16);
      }
      continue;
    }
    for (int l = 0; l < 8; ++l) {  // mixed per-lane
      const int32_t v = iv[l];
      if (v == 0) {
        ++run;
        continue;
      }
      flush_run(d, run);
      if (v > -125 && v < 125) {
        *d++ = (uint8_t)v;
      } else if (v >= -32768 && v <= 32767) {
        *d++ = B_VLESC2;
        *d++ = (uint8_t)v; *d++ = (uint8_t)(v >> 8);
      } else if (v >= -8388608 && v <= 8388607) {
        *d++ = B_VLESC3;
        *d++ = (uint8_t)v; *d++ = (uint8_t)(v >> 8); *d++ = (uint8_t)(v >> 16);
      } else {
        *d++ = B_VLESC4;
        uint32_t bits;
        std::memcpy(&bits, &fv[l], 4);
        *d++ = (uint8_t)bits; *d++ = (uint8_t)(bits >> 8);
        *d++ = (uint8_t)(bits >> 16); *d++ = (uint8_t)(bits >> 24);
      }
    }
  }
  flush_run(d, run);
  return d - out;
}

// Decode one block's stream (at most `avail` readable bytes) into `out`
// (cells floats); returns bytes consumed, or -1 when the stream is
// truncated or a token would write past `cells` values.  The bound makes
// corrupt containers fail loudly instead of reading out of bounds.
int64_t rle_decode_block(float mulfac, const uint8_t* src, int64_t avail,
                         float* out, int64_t cells) {
  const float scalefac = 1.0f / mulfac;
  const uint8_t* p = src;
  const uint8_t* const end = src + avail;
  int64_t n = 0;
  while (n < cells) {
    if (p >= end) return -1;
    const int8_t c = (int8_t)*p;
    if (c > -125 && c < 125) {
      out[n++] = (float)(int32_t)c * scalefac;
      p += 1;
    } else if (c == 127) {  // RLESC1
      if (p + 2 > end) return -1;
      int64_t run = p[1];
      if (n + run > cells) return -1;
      for (int64_t j = 0; j < run; ++j) out[n + j] = 0.0f;
      n += run;
      p += 2;
    } else if (c == 125) {  // RLESC3
      if (p + 4 > end) return -1;
      int64_t run = (int64_t)p[1] | ((int64_t)p[2] << 8) | ((int64_t)p[3] << 16);
      if (n + run > cells) return -1;
      for (int64_t j = 0; j < run; ++j) out[n + j] = 0.0f;
      n += run;
      p += 4;
    } else if (c == -125) {  // VLESC2
      if (p + 3 > end) return -1;
      int16_t q;
      std::memcpy(&q, p + 1, 2);
      out[n++] = (float)(int32_t)q * scalefac;
      p += 3;
    } else if (c == -127) {  // VLESC3
      if (p + 4 > end) return -1;
      int32_t q = (int32_t)p[1] | ((int32_t)p[2] << 8) | ((int32_t)p[3] << 16);
      if (q >= (1 << 23)) q -= (1 << 24);
      out[n++] = (float)q * scalefac;
      p += 4;
    } else if (c == -126) {  // VLESC2_8x
      if (p + 17 > end || n + 8 > cells) return -1;
      for (int l = 0; l < 8; ++l) {
        int16_t q;
        std::memcpy(&q, p + 1 + 2 * l, 2);
        out[n + l] = (float)(int32_t)q * scalefac;
      }
      n += 8;
      p += 17;
    } else if (c == 126) {  // VLESC3_8x
      if (p + 25 > end || n + 8 > cells) return -1;
      for (int l = 0; l < 8; ++l) {
        const uint8_t* b = p + 1 + 3 * l;
        int32_t q = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
        if (q >= (1 << 23)) q -= (1 << 24);
        out[n + l] = (float)q * scalefac;
      }
      n += 8;
      p += 25;
    } else {  // VLESC4 (c == -128)
      if (p + 5 > end) return -1;
      float f;
      std::memcpy(&f, p + 1, 4);
      out[n++] = f * scalefac;
      p += 5;
    }
  }
  return p - src;
}

// ------------------------------------------------------------- container

struct Grid {
  int nbx, nby, nbz;
  int64_t nnn;
};
inline Grid grid_of(int nx, int ny, int nz, int bx, int by, int bz) {
  Grid g;
  g.nbx = (nx + bx - 1) / bx;
  g.nby = (ny + by - 1) / by;
  g.nbz = (nz + bz - 1) / bz;
  g.nnn = (int64_t)g.nbx * g.nby * g.nbz;
  return g;
}

inline void extract_block(const float* vol, int nx, int ny, int nz, int x0,
                          int y0, int z0, int bx, int by, int bz, float* blk) {
  const int xs = std::min(bx, nx - x0), ys = std::min(by, ny - y0),
            zs = std::min(bz, nz - z0);
  std::memset(blk, 0, sizeof(float) * bx * by * bz);
  for (int z = 0; z < zs; ++z)
    for (int y = 0; y < ys; ++y)
      std::memcpy(blk + (int64_t)(z * by + y) * bx,
                  vol + ((int64_t)(z0 + z) * ny + (y0 + y)) * nx + x0,
                  sizeof(float) * xs);
}

inline void insert_block(float* vol, int nx, int ny, int nz, int x0, int y0,
                         int z0, int bx, int by, int bz, const float* blk) {
  const int xs = std::min(bx, nx - x0), ys = std::min(by, ny - y0),
            zs = std::min(bz, nz - z0);
  for (int z = 0; z < zs; ++z)
    for (int y = 0; y < ys; ++y)
      std::memcpy(vol + ((int64_t)(z0 + z) * ny + (y0 + y)) * nx + x0,
                  blk + (int64_t)(z * by + y) * bx, sizeof(float) * xs);
}

int num_threads_default() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return (int)std::max(1u, std::thread::hardware_concurrency());
#endif
}

constexpr int64_t RAW_FLAG = (int64_t)0x8000000000000000ull;

}  // namespace

extern "C" {

// ------------------------- building blocks exposed for the Python package

void cvx_wav_fwd_blocks(float* blocks, int64_t n, int bx, int by, int bz) {
  const int maxb = std::max(bx, std::max(by, bz));
#pragma omp parallel
  {
    std::vector<float> tmp(maxb);
#pragma omp for schedule(dynamic, 4)
    for (int64_t i = 0; i < n; ++i)
      wav_fwd_block(blocks + i * (int64_t)bx * by * bz, tmp.data(), bx, by, bz);
  }
}

void cvx_wav_inv_blocks(float* blocks, int64_t n, int bx, int by, int bz) {
  const int maxb = std::max(bx, std::max(by, bz));
#pragma omp parallel
  {
    std::vector<float> tmp(maxb);
#pragma omp for schedule(dynamic, 4)
    for (int64_t i = 0; i < n; ++i)
      wav_inv_block(blocks + i * (int64_t)bx * by * bz, tmp.data(), bx, by, bz);
  }
}

int64_t cvx_rle_encode_block(float mulfac, const float* vals, int64_t cells,
                             uint8_t* out) {
  return rle_encode_block(mulfac, vals, cells, out);
}

int64_t cvx_rle_decode_block(float mulfac, const uint8_t* src, int64_t avail,
                             float* out, int64_t cells) {
  return rle_decode_block(mulfac, src, avail, out, cells);
}

// Decode every block payload of a parsed container into a dense
// (nnn, cells) coefficient matrix. blkoffs carry the RAW flag in the MSB.
// `avail` bounds the payload area; returns 0 on success, -1 when any block
// is truncated / overruns (decoding stops at the buffer end either way).
int cvx_decode_payloads(const uint8_t* payload, int64_t avail,
                        const int64_t* blkoffs, const float* blkmulfac,
                        float glob_mulfac, int64_t nnn, int64_t cells,
                        float* out) {
  std::atomic<int> bad{0};
#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t i = 0; i < nnn; ++i) {
    const int64_t off = blkoffs[i];
    float* dst = out + i * cells;
    if (off & RAW_FLAG) {
      const int64_t o = off & ~RAW_FLAG;
      if (o < 0 || o + 4 * cells > avail) {
        std::memset(dst, 0, sizeof(float) * cells);
        bad.store(1, std::memory_order_relaxed);
      } else {
        std::memcpy(dst, payload + o, sizeof(float) * cells);
      }
    } else {
      const float mf = blkmulfac ? blkmulfac[i] : glob_mulfac;
      if (off < 0 || off >= avail ||
          rle_decode_block(mf, payload + off, avail - off, dst, cells) < 0) {
        std::memset(dst, 0, sizeof(float) * cells);
        bad.store(1, std::memory_order_relaxed);
      }
    }
  }
  return bad.load() ? -1 : 0;
}

// Encode a dense (nnn, cells) coefficient matrix into per-block streams.
// out must hold nnn * (5*cells+8) bytes at stride (5*cells+8); sizes[i]
// receives each stream size; raw[i] is set when the raw fallback applies
// (the caller then stores the coefficient bytes instead).
void cvx_encode_payloads(const float* coeffs, const float* mulfacs,
                         int64_t nnn, int64_t cells, uint8_t* out,
                         int64_t* sizes, uint8_t* raw) {
  const int64_t stride = 5 * cells + 8;
#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t i = 0; i < nnn; ++i) {
    int64_t s =
        rle_encode_block(mulfacs[i], coeffs + i * cells, cells, out + i * stride);
    raw[i] = s > 4 * cells;
    if (raw[i]) {
      std::memcpy(out + i * stride, coeffs + i * cells, sizeof(float) * cells);
      s = 4 * cells;
    }
    sizes[i] = s;
  }
}

// Ragged gather-copy: n independent memcpys (the container-assembly hot
// loop — the numpy fancy-index equivalent costs ~10x at typical chunk
// counts).  Bounds are the caller's contract (offsets it just computed).
void cvx_ragged_copy(const uint8_t* src, const int64_t* soff, uint8_t* dst,
                     const int64_t* doff, const int64_t* nbytes, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(dst + doff[i], src + soff[i], (size_t)nbytes[i]);
}

// Ragged copy that also zero-fills each destination span's alignment tail
// up to the next `align` boundary (the decode-plan stream packer: block
// payloads land W-aligned with deterministic zero gaps, without a separate
// full-buffer memset — the staging buffer is reused across volumes).
void cvx_ragged_copy_fill(const uint8_t* src, const int64_t* soff,
                          uint8_t* dst, const int64_t* doff,
                          const int64_t* nbytes, int64_t n, int64_t align) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t sz = nbytes[i];
    std::memcpy(dst + doff[i], src + soff[i], (size_t)sz);
    int64_t pad = (-sz) & (align - 1);
    if (pad) std::memset(dst + doff[i] + sz, 0, (size_t)pad);
  }
}

double cvx_sumsq_f64(const float* vol, int64_t n) {
  double acc = 0.0;
#pragma omp parallel for reduction(+ : acc)
  for (int64_t i = 0; i < n; ++i) acc += (double)vol[i] * (double)vol[i];
  return acc;
}

// Per-chunk nonzero flags over a dense coefficient buffer: used by the
// decompress path to build the chunk-sparse device upload (only chunks
// with surviving coefficients travel host->device).
void cvx_chunk_flags(const float* coeffs, int64_t nchunks, int64_t chunk,
                     uint8_t* flags) {
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const float* p = coeffs + c * chunk;
    uint8_t any = 0;
    for (int64_t i = 0; i < chunk; ++i) any |= (p[i] != 0.0f);
    flags[c] = any;
  }
}

// ---------------------------------------- full host codec + reference C ABI

static float host_compress(float scale, const float* vol, int nx, int ny,
                           int nz, int bx, int by, int bz, bool use_local_rms,
                           unsigned int* compressed, int num_threads,
                           int64_t* compressed_length, bool parity = false) {
#ifdef _OPENMP
  omp_set_num_threads(num_threads);
#endif
  const Grid g = grid_of(nx, ny, nz, bx, by, bz);
  const int64_t cells = (int64_t)bx * by * bz;
  const int64_t nvol = (int64_t)nx * ny * nz;

  float glob_mulfac = 1.0f;
  if (!use_local_rms) {
    const float rms = (float)std::sqrt(cvx_sumsq_f64(vol, nvol) / (double)nvol);
    if (rms != 0.0f) glob_mulfac = 1.0f / (rms * scale);
    if (!std::isfinite(glob_mulfac)) glob_mulfac = 1.0f;
  }

  uint32_t* hdr = compressed;
  hdr[0] = nx; hdr[1] = ny; hdr[2] = nz;
  hdr[3] = bx; hdr[4] = by; hdr[5] = bz;
  std::memcpy(&hdr[6], &glob_mulfac, 4);
  hdr[7] = use_local_rms ? 1u : 0u;

  int64_t* blkoffs = (int64_t*)(compressed + 8);
  float* blkmulfac = use_local_rms ? (float*)(blkoffs + g.nnn) : nullptr;
  uint8_t* payload = use_local_rms ? (uint8_t*)(blkmulfac + g.nnn)
                                   : (uint8_t*)(blkoffs + g.nnn);

  // pass 1: per-block transform+encode into private buffers (deterministic)
  std::vector<std::vector<uint8_t>> streams(g.nnn);
  std::vector<int64_t> sizes(g.nnn);
  std::vector<uint8_t> raws(g.nnn);
#pragma omp parallel
  {
    std::vector<float> blk(cells), tmp(std::max(bx, std::max(by, bz)));
    std::vector<uint8_t> enc(5 * cells + 8);
#pragma omp for schedule(dynamic, 2)
    for (int64_t i = 0; i < g.nnn; ++i) {
      const int iiz = (int)(i / ((int64_t)g.nbx * g.nby));
      const int64_t r = i - (int64_t)iiz * g.nbx * g.nby;
      const int iiy = (int)(r / g.nbx), iix = (int)(r % g.nbx);
      extract_block(vol, nx, ny, nz, iix * bx, iiy * by, iiz * bz, bx, by, bz,
                    blk.data());
      wav_fwd_block_ex(blk.data(), tmp.data(), bx, by, bz, parity);
      float mf = glob_mulfac;
      if (use_local_rms) {
        float lrms;
        if (parity) {
          // the reference's plain-AVX lane accumulation order
          // (Compute_Local_RMS, CvxCompress.cpp:119-142): 8 strided f32
          // lane sums, hadd-tree reduction, sqrtf(v/cells)
          float lane[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          for (int64_t c = 0; c < cells; c += 8)
            for (int l = 0; l < 8; ++l)
              lane[l] = lane[l] + blk[c + l] * blk[c + l];
          const float ss = ((lane[0] + lane[1]) + (lane[2] + lane[3])) +
                           ((lane[4] + lane[5]) + (lane[6] + lane[7]));
          lrms = sqrtf(ss / (float)cells);
        } else {
          double ss = 0.0;
          for (int64_t c = 0; c < cells; ++c) ss += (double)blk[c] * blk[c];
          lrms = (float)std::sqrt(ss / (double)cells);
        }
        mf = lrms != 0.0f ? 1.0f / (lrms * scale) : 1.0f;
        if (!std::isfinite(mf)) mf = 1.0f;
        blkmulfac[i] = mf;
      }
      int64_t s = rle_encode_block(mf, blk.data(), cells, enc.data());
      raws[i] = s > 4 * cells;
      if (raws[i]) {
        streams[i].assign((uint8_t*)blk.data(),
                          (uint8_t*)blk.data() + 4 * cells);
        sizes[i] = 4 * cells;
      } else {
        streams[i].assign(enc.data(), enc.data() + s);
        sizes[i] = s;
      }
    }
  }

  // pass 2: prefix offsets (block order, deterministic) + parallel pack
  std::vector<int64_t> bases(g.nnn + 1, 0);
  for (int64_t i = 0; i < g.nnn; ++i) bases[i + 1] = bases[i] + sizes[i];
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < g.nnn; ++i) {
    blkoffs[i] = raws[i] ? (bases[i] | RAW_FLAG) : bases[i];
    std::memcpy(payload + bases[i], streams[i].data(), sizes[i]);
  }

  int64_t len = 32 + 8 * g.nnn + bases[g.nnn] + 7;
  if (use_local_rms) len += 4 * g.nnn;
  *compressed_length = len;
  return (float)(((double)nvol * 4.0) / (double)len);
}

static void host_decompress(float* vol, int nx, int ny, int nz,
                            const unsigned int* compressed, int num_threads,
                            int64_t compressed_length, bool parity = false) {
#ifdef _OPENMP
  omp_set_num_threads(num_threads);
#endif
  const uint32_t* hdr = compressed;
  assert((int)hdr[0] == nx && (int)hdr[1] == ny && (int)hdr[2] == nz);
  const int bx = hdr[3], by = hdr[4], bz = hdr[5];
  float glob_mulfac;
  std::memcpy(&glob_mulfac, &hdr[6], 4);
  const bool use_local = (hdr[7] & 1) != 0;
  const Grid g = grid_of(nx, ny, nz, bx, by, bz);
  const int64_t cells = (int64_t)bx * by * bz;
  const int64_t* blkoffs = (const int64_t*)(compressed + 8);
  const float* blkmulfac =
      use_local ? (const float*)(blkoffs + g.nnn) : nullptr;
  const uint8_t* payload = use_local
                               ? (const uint8_t*)(blkmulfac + g.nnn)
                               : (const uint8_t*)(blkoffs + g.nnn);
  // payload-area bound; a caller passing length <= 0 (unknown) gets the
  // legacy trust-the-offset-table behavior
  const int64_t avail =
      compressed_length > 0
          ? compressed_length - (payload - (const uint8_t*)compressed)
          : INT64_MAX;
#pragma omp parallel
  {
    std::vector<float> blk(cells), tmp(std::max(bx, std::max(by, bz)));
#pragma omp for schedule(dynamic, 2)
    for (int64_t i = 0; i < g.nnn; ++i) {
      const int iiz = (int)(i / ((int64_t)g.nbx * g.nby));
      const int64_t r = i - (int64_t)iiz * g.nbx * g.nby;
      const int iiy = (int)(r / g.nbx), iix = (int)(r % g.nbx);
      const int64_t off = blkoffs[i];
      bool ok = true;
      if (off & RAW_FLAG) {
        const int64_t o = off & ~RAW_FLAG;
        ok = o >= 0 && o + 4 * cells <= avail;
        if (ok)
          std::memcpy(blk.data(), payload + o, sizeof(float) * cells);
      } else {
        const float mf = use_local ? blkmulfac[i] : glob_mulfac;
        ok = off >= 0 && off < avail &&
             rle_decode_block(mf, payload + off, avail - off, blk.data(),
                              cells) >= 0;
      }
      if (!ok) std::memset(blk.data(), 0, sizeof(float) * cells);
      wav_inv_block_ex(blk.data(), tmp.data(), bx, by, bz, parity);
      insert_block(vol, nx, ny, nz, iix * bx, iiy * by, iiz * bz, bx, by, bz,
                   blk.data());
    }
  }
}

// ---- reference-compatible C ABI (CvxCompress.hxx:139-192) ----

float cvx_compress(float scale, float* vol, int nx, int ny, int nz, int bx,
                   int by, int bz, unsigned int* compressed,
                   long* compressed_length) {
  int64_t len;
  const float ratio = host_compress(scale, vol, nx, ny, nz, bx, by, bz, false,
                                    compressed, num_threads_default(), &len);
  *compressed_length = (long)len;
  return ratio;
}

float cvx_compress_th(float scale, float* vol, int nx, int ny, int nz, int bx,
                      int by, int bz, bool use_local_RMS,
                      unsigned int* compressed, int num_threads,
                      long* compressed_length) {
  int64_t len;
  const float ratio = host_compress(scale, vol, nx, ny, nz, bx, by, bz,
                                    use_local_RMS, compressed, num_threads, &len);
  *compressed_length = (long)len;
  return ratio;
}

void cvx_decompress_inplace(float* vol, int nx, int ny, int nz,
                            unsigned int* compressed, long compressed_length) {
  host_decompress(vol, nx, ny, nz, compressed, num_threads_default(),
                  (int64_t)compressed_length);
}

void cvx_decompress_inplace_th(float* vol, int nx, int ny, int nz,
                               unsigned int* compressed, int num_threads,
                               long compressed_length) {
  host_decompress(vol, nx, ny, nz, compressed, num_threads,
                  (int64_t)compressed_length);
}

float* cvx_decompress_outofplace(int* nx, int* ny, int* nz,
                                 unsigned int* compressed,
                                 long compressed_length) {
  *nx = (int)compressed[0];
  *ny = (int)compressed[1];
  *nz = (int)compressed[2];
  float* vol = (float*)std::malloc(sizeof(float) * (int64_t)(*nx) * (*ny) * (*nz));
  cvx_decompress_inplace(vol, *nx, *ny, *nz, compressed, compressed_length);
  return vol;
}

// ---- bit-parity entry points (plain-AVX reference build order) ----

float cvx_compress_parity_th(float scale, float* vol, int nx, int ny, int nz,
                             int bx, int by, int bz, bool use_local_RMS,
                             unsigned int* compressed, int num_threads,
                             long* compressed_length) {
  int64_t len;
  const float ratio =
      host_compress(scale, vol, nx, ny, nz, bx, by, bz, use_local_RMS,
                    compressed, num_threads, &len, true);
  *compressed_length = (long)len;
  return ratio;
}

void cvx_decompress_inplace_parity_th(float* vol, int nx, int ny, int nz,
                                      unsigned int* compressed,
                                      int num_threads,
                                      long compressed_length) {
  host_decompress(vol, nx, ny, nz, compressed, num_threads,
                  (int64_t)compressed_length, true);
}

}  // extern "C"
