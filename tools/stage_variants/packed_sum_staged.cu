// A variant of packed_sum_pool_kernel<POOL, G> (csrc/packed_sum_pool.cu)
// for tools/stage_ab.py, which copies the package and puts this text in
// place of the shipped kernel and of its launch_sum<POOL, G>; nothing builds
// it otherwise. The same tiles, table and arithmetic as the shipped kernel;
// the difference is where the bytes go:
//   1. stage: the tile's run of every input and of r (SUM: `tile`
//      consecutive slots; POOL: 2 `tile` slots of each of the two input
//      rows), each contiguous in its tensor, goes into shared memory as the
//      16-byte units that cover it, in one walk over all runs spread over
//      the block's threads (a thread finds its run by walking the runs'
//      ends, which only moves forward);
//   2. sum: thread (tx, ty) holds element tx of the lanes (its input found
//      once by a binary search) and output slots ty, ty + by, ...; it reads
//      the staged y and r elements, adds them (and takes the 2x2 max) and
//      writes the result into a staged output tile;
//   3. store: the output tile, a contiguous byte range of the output, leaves
//      as 16-byte units with a byte head and tail.
// A launch that computes only some of the lanes (more than MAX_IN inputs)
// stores its elements straight from step 2.

constexpr int STAGE_UNROLL = 4;  // loads in flight per thread

template <bool POOL, int G>
__device__ __forceinline__ uint4 lds_el(const uint8_t* p) {
  if constexpr (G == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (G == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_uint4(v.x, v.y, 0u, 0u);
  } else if constexpr (G == 4) {
    return make_uint4(*reinterpret_cast<const uint32_t*>(p), 0u, 0u, 0u);
  } else {
    return make_uint4(*p, 0u, 0u, 0u);
  }
}

template <bool POOL, int G>
__device__ __forceinline__ uint4 summed_s(const uint8_t* y, const uint8_t* r) {
  const uint4 a = lds_el<POOL, G>(y), b = lds_el<POOL, G>(r);
  return make_uint4(sat_sum(a.x, b.x), sat_sum(a.y, b.y), sat_sum(a.z, b.z),
                    sat_sum(a.w, b.w));
}

template <bool POOL, int G>
__global__ void __launch_bounds__(NT)
    packed_sum_pool_kernel(const __grid_constant__ SumPoolArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int NSEG = POOL ? 2 : 1;
  __shared__ const uint8_t* s_src[NSEG * (MAX_IN + 1)];
  __shared__ int s_end[NSEG * (MAX_IN + 1)], s_ph[NSEG * (MAX_IN + 1)];
  __shared__ int s_cp[MAX_IN], s_lane[MAX_IN];
  const int tid = threadIdx.x;
  int qt;
  long long q0, s0;  // the tile's first output slot and first input slot
  if constexpr (POOL) {
    const int half = a.iwp / 2;
    const int orow = blockIdx.x / a.chunks;
    const int c0 = (blockIdx.x - orow * a.chunks) * a.tile;
    qt = min(a.tile, half - c0);
    q0 = (long long)orow * half + c0;
    s0 = 2LL * orow * a.iwp + 2 * c0;
  } else {
    s0 = q0 = (long long)blockIdx.x * a.tile;
    qt = (int)min((long long)a.tile, a.slots - s0);
  }
  const int ns = POOL ? 2 * qt : qt;  // slots of a run
  const int nr = a.n_y + 1;           // runs of a segment: the inputs, r
  // the runs: the 16-byte units that cover each, their first byte's phase
  // in the first unit; a warp reads one entry of the parameter at a time
  for (int k = tid >> 5; k < NSEG * nr; k += NT / 32) {
    const int g = k / nr, i = k - g * nr;
    const uint8_t* base = a.r;
    int cp = a.cp;
    if (i < a.n_y) {
      const SumPoolIn in = a.in[i];
      base = in.y;
      cp = in.cp;
      if ((tid & 31) == 0 && g == 0) {
        s_cp[i] = in.cp;
        s_lane[i] = in.lane;
      }
    }
    if ((tid & 31) == 0) {
      const long long b0 = (s0 + (long long)g * a.iwp) * cp;
      const long long b1 = b0 + (long long)ns * cp;
      s_src[k] = base + (b0 & ~15LL);
      s_ph[k] = (int)(b0 & 15);
      s_end[k] = (int)(((b1 + 15) >> 4) - (b0 >> 4));
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 1; k < NSEG * nr; ++k) s_end[k] += s_end[k - 1];
  __syncthreads();
  const int total = s_end[NSEG * nr - 1];
  uint4* const st = reinterpret_cast<uint4*>(sm);
  {
    int k = 0;  // the run of this thread's unit: only moves forward
    for (int g0 = tid; g0 < total; g0 += STAGE_UNROLL * NT) {
      uint4 v[STAGE_UNROLL];
      int at[STAGE_UNROLL];
#pragma unroll
      for (int j = 0; j < STAGE_UNROLL; ++j) {
        const int g = g0 + j * NT;
        at[j] = -1;
        if (g < total) {
          while (g >= s_end[k]) ++k;
          const int u0 = k ? s_end[k - 1] : 0;
          v[j] = __ldg(reinterpret_cast<const uint4*>(s_src[k]) + (g - u0));
          at[j] = g;
        }
      }
#pragma unroll
      for (int j = 0; j < STAGE_UNROLL; ++j)
        if (at[j] >= 0) st[at[j]] = v[j];
    }
  }
  __syncthreads();
  const bool whole = a.lo == 0 && a.hi == a.cp;
  const long long B0 = q0 * a.cp, B1 = B0 + (long long)qt * a.cp;
  uint8_t* const o = sm + 16 * total + (B0 & 15);
  const int nl = (a.hi - a.lo) / G;
  const int bx = min(nl, NT), by = NT / bx;
  const int tx = tid % bx, ty = tid / bx;
  if (ty < by) {
    const int cr = a.cp;
    for (int l = tx; l < nl; l += bx) {
      const int lane = a.lo + l * G;
      int lo = 0, hi = a.n_y - 1;  // the input holding `lane`
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_lane[mid] + s_cp[mid] > lane) hi = mid;
        else lo = mid + 1;
      }
      const int cy = s_cp[lo];
      const uint8_t* yb[NSEG];
      const uint8_t* rb[NSEG];
#pragma unroll
      for (int g = 0; g < NSEG; ++g) {
        const int ky = g * nr + lo, kr = g * nr + a.n_y;
        yb[g] = sm + 16 * (ky ? s_end[ky - 1] : 0) + s_ph[ky] +
                (lane - s_lane[lo]);
        rb[g] = sm + 16 * s_end[kr - 1] + s_ph[kr] + lane;
      }
      for (int q = ty; q < qt; q += by) {
        uint4 v;
        if constexpr (POOL) {
          v = max4(max4(summed_s<POOL, G>(yb[0] + 2 * q * cy,
                                          rb[0] + 2 * q * cr),
                        summed_s<POOL, G>(yb[0] + (2 * q + 1) * cy,
                                          rb[0] + (2 * q + 1) * cr)),
                   max4(summed_s<POOL, G>(yb[1] + 2 * q * cy,
                                          rb[1] + 2 * q * cr),
                        summed_s<POOL, G>(yb[1] + (2 * q + 1) * cy,
                                          rb[1] + (2 * q + 1) * cr)));
        } else {
          v = summed_s<POOL, G>(yb[0] + q * cy, rb[0] + q * cr);
        }
        if (whole) store_el<G>(o + q * cr + lane, v);
        else store_el<G>(a.out + (q0 + q) * cr + lane, v);
      }
    }
  }
  if (!whole) return;
  __syncthreads();
  // the output tile's bytes [B0, B1): a head up to a 16-byte boundary,
  // whole units, a tail
  const long long U0 = (B0 + 15) >> 4, U1 = B1 >> 4;
  const long long H = min(B1, U0 << 4), T0 = max(U1 << 4, H);
  for (long long b = B0 + tid; b < H; b += NT) a.out[b] = o[b - B0];
  for (long long b = T0 + tid; b < B1; b += NT) a.out[b] = o[b - B0];
  for (long long u = U0 + tid; u < U1; u += NT)
    reinterpret_cast<uint4*>(a.out)[u] =
        *reinterpret_cast<const uint4*>(o + ((u << 4) - B0));
}

template <bool POOL, int G>
cudaError_t launch_sum(const SumPoolArgs& a, long long tiles,
                       cudaStream_t stream) {
  // the staged runs (each at most 2 units more than its bytes) and the
  // output tile
  const long long ns = POOL ? 2LL * a.tile : a.tile;
  long long units = (ns * a.cp + 15) / 16 + 2;
  for (int i = 0; i < a.n_y; ++i) units += (ns * a.in[i].cp + 15) / 16 + 2;
  const long long smem =
      (POOL ? 2 : 1) * units * 16 + (long long)a.tile * a.cp + 32;
  if (smem > (227 << 10)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      packed_sum_pool_kernel<POOL, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  packed_sum_pool_kernel<POOL, G><<<(unsigned)tiles, NT, (size_t)smem,
                                    stream>>>(a);
  return cudaGetLastError();
}

