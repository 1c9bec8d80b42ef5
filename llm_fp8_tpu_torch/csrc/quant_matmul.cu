// K1: y[M,N] = x[M,K] (bf16) @ dequant(w[K,N]) with a float32 accumulator.
//
// Replaces llm_fp8_tpu/kernels/quant_matmul.py::quant_matmul (Pallas kernels
// _kernel_tensor_or_channel and _kernel_mx). Modes: "tensor" and "channel"
// scale the accumulator after the dot (the scale is constant along K); "mx"
// multiplies each 32-row weight block by its power-of-two scale before it
// (scales vary along K). Weights are e4m3, e5m2 or int8 codes.
//
// Bound on the H100: at decode (M = slots = 8) every weight byte is read once
// for 16 FLOPs, far below the 295 FLOP/byte ridge, so the kernel is bound by
// the K*N weight bytes (gate|up at 1B: 33.6 MB → 10 µs at 3.35 TB/s). At
// prefill (M ≥ 128) it is bound by the bf16 tensor cores (989 TFLOP/s).
//
// Two kernels; the wrapper picks by shape (kernels/quant_matmul.py).
//
// The decode kernel (M < 64, and every shape the prefill kernel's TMA
// cannot take, any M: groups of 64 rows of x in grid z). What bounds it is
// the K·N code bytes. It computes yᵀ = dequant(w)ᵀ · xᵀ on mma.sync
// m16n8k16: the 16 rows of a product are output columns and its 8 columns
// rows of x, so at 8 slots no row of a product is padding (the first
// design's WMMA tiles were half zeros). Each warp streams its own k slice
// through a 4-stage cp.async ring of 32-row stages (codes, x and the bf16
// MX scales of the stage): no block barrier in the loop, about 48 KB in
// flight on an SM at M = 8. A lane reads 8 codes of four k rows, pairs rows
// k and k + 1 with a byte permute and converts four codes at a time
// straight into A fragments (decode_split.cuh's codes4_to_bf16x2, which
// K2 and K5 use too: e4m3 by the FTZ route, e5m2 and int8 exactly); MX
// scales multiply the bf16 pairs (fma.rn.bf16x2, exact for a power of two:
// chip_smoke.py checks every code against every scale bit for bit). No bf16
// weight tile is written back. x's B fragments come by ldmatrix. K splits across the blocks of a cluster (split_plan in the
// wrapper, from the shapes alone): the four warps of a block sum in shared
// memory in warp order, each rank pushes every other rank's share of those
// sums into that rank's shared memory, and each sums the shares it holds in
// rank order, scales and stores them: one launch, no float32 workspace,
// reruns bit-identical. A merge through device memory (float32 partials,
// the last block of a column tile to arrive summing them) gave the same
// bits but was 1.7-2.4 µs slower at the 1B qkv and out projections on the
// H100 (python -m llm_fp8_tpu_torch.scripts.kernel_variants k1-merge).
//
// The prefill kernel (M ≥ 64; K a multiple of 8, N of 16): one
// producer thread keeps TMA loads of x tiles (bf16, 128-byte swizzle) and
// weight-code tiles (1 byte, [64 k][128 n], N contiguous) in a 4-stage
// mbarrier ring. Two consumer warpgroups dequantize each code tile once into
// a 3-deep ring of bf16 tiles in the swizzled MN-major layout wgmma reads
// (e4m3: the 7 payload bits re-seated in a float and one mul.ftz by 2^120,
// which flushes the subnormal codes; MX: times the scale in float, rounded
// once, as the plain version), 32 codes a thread, while the tensor cores
// run the products of the tile before: wgmma SS m64n128k16 (x K-major, the
// bf16 weight tile MN-major) with float32 accumulators in registers, each
// warpgroup owning 64 or 128 rows (128- or 256-row blocks) of a 128-column
// tile; one named barrier a k tile joins the two warpgroups. The design is
// SS and not the swapped-operand RS form: with the codes N-contiguous, an RS
// A fragment would gather single bytes across rows, while the converter reads
// 8 codes and writes 16 bytes at a time, 8 lanes to a swizzled row (no bank
// conflicts). Blocks are persistent (one per SM, walking the output tiles),
// so a tile's first loads overlap the epilogue of the tile before. The
// epilogue applies the tensor or channel scale and casts; a bf16 output is
// stored as 16-byte column groups after a transpose within each quad of
// lanes. Tried on the H100 and dropped, each slower at M = 8192: a separate
// converter warpgroup (its four warps could not keep the tensor cores fed),
// clusters of two blocks sharing x tiles by TMA multicast, integer
// e4m3 → bf16 bit moves in place of the float multiply, and a dequantize two
// k tiles ahead with a 4-deep weight ring (the TMA stages then come free a
// tile later than their loads need). The dequantize on
// the consumers' critical path and each tile's epilogue are what keep it
// behind torch.matmul's bf16 GEMM (PERF.md).
//
// The prefill kernel splits K, when its (M, N) grid cannot fill the card,
// across blocks that write float32 partials, and a second kernel sums them
// in a fixed order, applies the scale and casts (deterministic, no atomics).
// Both kernels mask ragged M, N and K edges (or TMA reads them as zeros);
// nothing is padded in device memory. MX scales are read as stored (bf16).
#include "decode_split.cuh"
#include "fp8_ftz.cuh"
#include "hopper.cuh"

namespace {

constexpr int kModeTensor = 0, kModeChannel = 1, kModeMX = 2;

// Weight code → float as the TPU kernel's _dequant_to: e4m3 by the FTZ
// route, e5m2 and int8 by an exact convert.
template <int KIND>
__device__ __forceinline__ float weight_to_float(uint32_t b) {
  if constexpr (KIND == kCodeE5M2) return e5m2_exact_to_float(b);
  else return code_to_float<KIND>(b);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// ---- the decode kernel ----

constexpr int kDWarps = 4;                 // a block's warps, each its own k slice
constexpr int kDThreads = 32 * kDWarps;
constexpr int kDCols = 64;                 // output columns per block
constexpr int kDRows = 32;                 // k rows per stage (one MX block)
constexpr int kDStages = 4;                // cp.async ring depth of a warp
constexpr int kDCodePitch = kDCols + 16;   // bytes: a quad's rows 2t hit four bank groups
constexpr int kDXPitch = 2 * kDRows + 16;  // bytes: ldmatrix's eight rows hit eight
constexpr int kDRedPitch = kDCols + 4;     // floats: the epilogue's staging

// One stage of a warp's ring, for groups of 8·MT rows of x.
template <int MT, bool MX>
struct DStage {
  static constexpr int X = kDRows * kDCodePitch;          // codes [32 k][64 n]
  static constexpr int SC = X + 8 * MT * kDXPitch;        // x [8·MT m][32 k] bf16
  static constexpr int BYTES = SC + (MX ? 2 * kDCols : 0);  // MX scales [64 n] bf16
  static constexpr int RING = kDStages * BYTES;           // one warp's ring
  static constexpr int RED = kDWarps * 8 * MT * kDRedPitch * 4;  // the epilogue's staging
  // The ranks' shares pushed here: [rank][share] floats, then an mbarrier.
  static constexpr int RECV = kDWarps * RING > RED ? kDWarps * RING : RED;
  static constexpr int BAR = RECV + 8 * MT * kDCols * 4;
  static constexpr int SMEM = BAR + 8;
};

// Copies 16 bytes of which the first n (0..16) come from src and the rest
// are zeros: cp.async when vec (src 16-byte aligned, n 0 or 16; `safe` is
// read in place of src when n is 0), else byte by byte.
__device__ __forceinline__ void copy16(unsigned char* dst, const unsigned char* src, int n,
                                       bool vec, const void* safe) {
  if (vec) {
    decode_split::cp_async16_zfill(dst, n > 0 ? src : safe, n > 0 ? 16 : 0);
  } else {
    __align__(16) uint8_t b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = j < n ? src[j] : 0;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// ---- the cluster's merge: each rank pushes its shares into the ranks that
// sum them, then arrives on their mbarriers ----

__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void cluster_arrive(uint32_t bar) {
  asm volatile(
      "fence.acq_rel.cluster;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
      : "memory");
}

// Waits (acquire, cluster scope) until the phase of parity 0 has completed.
__device__ __forceinline__ void cluster_wait_bar(uint32_t bar) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

using decode_split::codes4_to_bf16x2;

// Two bf16 pairs multiplied, rounded once (the MX scale: a power of two, so
// the product is the plain version's (w.float() * s).to(bf16)).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// yᵀ = dequant(w)ᵀ · xᵀ on mma.sync m16n8k16 (bf16, float32 sums): the 16
// rows of a product are 16 output columns and its 8 columns 8 rows of x, so
// no row is padding at 8 slots. Block (split z, column tile, group of 8·MT
// rows of x) = four warps on the same 64 columns, warp q taking the q-th
// quarter of the split's k tiles through its own 4-stage cp.async ring
// (codes, x and MX scales of 32 k rows a stage). Lane (g, t) owns columns
// 8g .. 8g + 7 and k rows 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-row step: it
// reads 8 codes of each row (one 8-byte load), interleaves rows k and k + 1
// with __byte_perm and converts four codes at a time into the A fragments
// of four products (tile T: columns 8g + 2T and 8g + 2T + 1 as its rows g
// and g + 8); x's B fragments come by ldmatrix. The warps' sums meet in
// shared memory in warp order; the splits of a column tile are the blocks
// of one cluster: each rank pushes the share of its sums that rank q
// finishes into q's shared memory and arrives on q's mbarrier, then sums
// the shares pushed to it in rank order, scales and stores them (one
// cluster barrier, split across the kernel, and no remote loads).
template <int MT, int KIND, bool MX>
__global__ void __launch_bounds__(kDThreads)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                  const void* __restrict__ scale, void* __restrict__ out, int M, int N, int K,
                  int mode, int out_f32, int k_tiles_per_split) {
  using St = DStage<MT, MX>;
  constexpr int RR = 8 * MT;  // rows of x a block takes
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.y * kDCols, m0 = blockIdx.z * RR;
  const int splits = gridDim.x;
  const uint32_t recv_bar = hopper::smem_u32(smem + St::BAR);
  if (splits > 1) {
    if (threadIdx.x == 0) {
      hopper::mbar_init(recv_bar, splits);  // one arrival per rank
      hopper::mbar_fence_init();
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int k_tiles = (K + kDRows - 1) / kDRows;
  const int kb = min(static_cast<int>(blockIdx.x) * k_tiles_per_split, k_tiles);
  const int ke = min(kb + k_tiles_per_split, k_tiles);
  const int per = (ke - kb + kDWarps - 1) / kDWarps;
  const int w0 = min(kb + warp * per, ke), nt = min(w0 + per, ke) - w0;
  const __nv_bfloat16* sc16 = static_cast<const __nv_bfloat16*>(scale);
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool s_vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  unsigned char* ring = smem + warp * St::RING;
  // Every copy of this warp whole and aligned: no bounds to check.
  const bool fast = w_vec && x_vec && (!MX || s_vec) && n0 + kDCols <= N && m0 + RR <= M &&
                    (w0 + nt) * kDRows <= K;
  // This lane's chunks of the warp's first k tile: code rows lane / 4 + 8i,
  // bytes 16 (lane % 4); x rows lane / 4 + 8i, k 8 (lane % 4); MX scales
  // 8 lane.
  const uint8_t* w_src = w + static_cast<size_t>(w0 * kDRows + lane / 4) * N + n0 + 16 * (lane % 4);
  const __nv_bfloat16* x_src =
      x + static_cast<size_t>(m0 + lane / 4) * K + w0 * kDRows + 8 * (lane % 4);
  const __nv_bfloat16* s_src = sc16 + static_cast<size_t>(w0) * N + n0 + 8 * (lane % 8);
  const int code_dst = (lane / 4) * kDCodePitch + 16 * (lane % 4);
  const int x_dst = St::X + (lane / 4) * kDXPitch + 16 * (lane % 4);

  // Stage j of this warp: k tile w0 + j; past nt an empty group keeps the
  // count of groups in flight.
  auto issue = [&](int j) {
    if (j < nt && fast) {
      unsigned char* st = ring + (j % kDStages) * St::BYTES;
      const uint8_t* ws = w_src + static_cast<size_t>(j) * kDRows * N;
#pragma unroll
      for (int i = 0; i < kDRows / 8; ++i)
        decode_split::cp_async16_zfill(st + code_dst + 8 * i * kDCodePitch,
                                       ws + static_cast<size_t>(8 * i) * N, 16);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        decode_split::cp_async16_zfill(st + x_dst + 8 * i * kDXPitch,
                                       x_src + static_cast<size_t>(8 * i) * K + j * kDRows, 16);
      if constexpr (MX)
        if (lane < kDCols / 8)
          decode_split::cp_async16_zfill(st + St::SC + 16 * lane,
                                         s_src + static_cast<size_t>(j) * N, 16);
    } else if (j < nt) {
      unsigned char* st = ring + (j % kDStages) * St::BYTES;
      const int k0 = (w0 + j) * kDRows;
#pragma unroll
      for (int i = 0; i < kDRows * kDCols / 16 / 32; ++i) {
        const int c = lane + 32 * i, r = c / 4, col = n0 + (c % 4) * 16, k = k0 + r;
        const int n = k < K ? max(0, min(16, N - col)) : 0;
        copy16(st + r * kDCodePitch + (c % 4) * 16, w + static_cast<size_t>(k) * N + col, n,
               w_vec, w);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int c = lane + 32 * i, r = c / 4, k = k0 + (c % 4) * 8, m = m0 + r;
        const int n = m < M ? 2 * max(0, min(8, K - k)) : 0;
        copy16(st + St::X + r * kDXPitch + (c % 4) * 16,
               reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(m) * K + k), n,
               x_vec, x);
      }
      if constexpr (MX) {
        if (lane < kDCols / 8) {
          const int col = n0 + 8 * lane;
          const int n = 2 * max(0, min(8, N - col));
          copy16(st + St::SC + 16 * lane,
                 reinterpret_cast<const unsigned char*>(sc16 + static_cast<size_t>(k0 / 32) * N +
                                                        col),
                 n, s_vec, scale);
        }
      }
    }
    decode_split::cp_async_commit();
  };

  float acc[4][MT][4];
#pragma unroll
  for (int T = 0; T < 4; ++T)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[T][mt][e] = 0.0f;

#pragma unroll
  for (int j = 0; j < kDStages - 1; ++j) issue(j);
  for (int j = 0; j < nt; ++j) {
    issue(j + kDStages - 1);
    decode_split::cp_async_wait<kDStages - 1>();
    __syncwarp();
    const unsigned char* st = ring + (j % kDStages) * St::BYTES;
    uint32_t s2[8];  // MX: the scale of column 8g + c as a bf16 pair
    if constexpr (MX) {
      const uint4 sv = *reinterpret_cast<const uint4*>(st + St::SC + 16 * g);
      const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) s2[c] = __byte_perm(sw[c / 2], 0u, (c & 1) ? 0x3232 : 0x1010);
    }
    uint32_t bx[MT][4];  // x: B fragments of both 16-row steps
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(bx[mt], st + St::X + (8 * mt + lane % 8) * kDXPitch + 16 * (lane / 8));
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const unsigned char* row = st + (16 * ks + 2 * t) * kDCodePitch + 8 * g;
      const uint2 r0 = *reinterpret_cast<const uint2*>(row);
      const uint2 r1 = *reinterpret_cast<const uint2*>(row + kDCodePitch);
      const uint2 r8 = *reinterpret_cast<const uint2*>(row + 8 * kDCodePitch);
      const uint2 r9 = *reinterpret_cast<const uint2*>(row + 9 * kDCodePitch);
      uint32_t lo[8], hi[8];  // column 8g + c: rows (2t, 2t + 1) and (2t + 8, 2t + 9)
      codes4_to_bf16x2<KIND, true>(__byte_perm(r0.x, r1.x, 0x5140), lo[0], lo[1]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r0.x, r1.x, 0x7362), lo[2], lo[3]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r0.y, r1.y, 0x5140), lo[4], lo[5]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r0.y, r1.y, 0x7362), lo[6], lo[7]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r8.x, r9.x, 0x5140), hi[0], hi[1]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r8.x, r9.x, 0x7362), hi[2], hi[3]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r8.y, r9.y, 0x5140), hi[4], hi[5]);
      codes4_to_bf16x2<KIND, true>(__byte_perm(r8.y, r9.y, 0x7362), hi[6], hi[7]);
      if constexpr (MX) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          lo[c] = mul_bf16x2(lo[c], s2[c]);
          hi[c] = mul_bf16x2(hi[c], s2[c]);
        }
      }
#pragma unroll
      for (int T = 0; T < 4; ++T) {
        const uint32_t a[4] = {lo[2 * T], lo[2 * T + 1], hi[2 * T], hi[2 * T + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          decode_split::mma16816(acc[T][mt], a, bx[mt][2 * ks], bx[mt][2 * ks + 1]);
      }
    }
    __syncwarp();  // the stage is refilled by the next issue
  }
  decode_split::cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the staging below reuses them

  // Element e of acc[T][mt] is column 8g + 2T + (e >> 1), row 8mt + 2t + (e & 1).
  float* red = reinterpret_cast<float*>(smem);  // [warp][RR][kDRedPitch]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = red + (warp * RR + 8 * mt + 2 * t + e) * kDRedPitch + 8 * g;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0][mt][e], acc[0][mt][2 + e], acc[1][mt][e], acc[1][mt][2 + e]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[2][mt][e], acc[2][mt][2 + e], acc[3][mt][e], acc[3][mt][2 + e]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < RR * kDCols; i += kDThreads) {  // warp order
    const int r = i / kDCols, c = i % kDCols;
    float v = red[r * kDRedPitch + c];
#pragma unroll
    for (int q = 1; q < kDWarps; ++q) v += red[(q * RR + r) * kDRedPitch + c];
    red[r * kDRedPitch + c] = v;
  }

  __syncthreads();
  const int share = RR * kDCols / splits, me = static_cast<int>(blockIdx.x);
  const float* recv = reinterpret_cast<const float*>(smem + St::RECV);  // [rank][share]
  if (splits > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank's mbarrier is set
    for (int i = threadIdx.x; i < RR * kDCols; i += kDThreads) {
      const int q = i / share;
      cluster_store(cluster_addr(hopper::smem_u32(recv + me * share + i % share), q),
                    red[(i / kDCols) * kDRedPitch + i % kDCols]);
    }
    __syncthreads();  // the block's pushes are issued
    if (static_cast<int>(threadIdx.x) < splits) cluster_arrive(cluster_addr(recv_bar, threadIdx.x));
    cluster_wait_bar(recv_bar);  // every rank's share for this one has landed
  }
  for (int j = threadIdx.x; j < share; j += kDThreads) {
    const int i = me * share + j, r = i / kDCols, c = i % kDCols, m = m0 + r, n = n0 + c;
    float v = red[r * kDRedPitch + c];
    if (splits > 1) {
      v = recv[j];
      for (int q = 1; q < splits; ++q) v += recv[q * share + j];  // rank order
    }
    if (m >= M || n >= N) continue;
    if (mode == kModeTensor) v *= static_cast<const float*>(scale)[0];
    else if (mode == kModeChannel) v *= static_cast<const float*>(scale)[n];
    const size_t o = static_cast<size_t>(m) * N + n;
    if (out_f32) static_cast<float*>(out)[o] = v;
    else static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

template <int MT, int KIND, bool MX>
int launch_decode(const void* x, const void* w, const void* scale, void* out, int M, int N,
                  int K, int mode, int out_f32, int splits, int ktps, cudaStream_t s) {
  using St = DStage<MT, MX>;
  auto kernel = qmm_decode_kernel<MT, KIND, MX>;
  // The shared-memory limit is set once per kernel instance (a
  // function-local static), not on every launch of the decode step.
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, St::SMEM);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kDCols - 1) / kDCols, (M + 8 * MT - 1) / (8 * MT));
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = St::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const uint8_t*>(w), scale, out, M, N,
                                             K, mode, out_f32, ktps));
}

template <int MT>
int launch_decode_kind(int kind, int mode, const void* x, const void* w, const void* scale,
                       void* out, int M, int N, int K, int out_f32, int splits, int ktps,
                       cudaStream_t s) {
#define K1_DECODE(KIND)                                                                    \
  return mode == kModeMX ? launch_decode<MT, KIND, true>(x, w, scale, out, M, N, K, mode,  \
                                                         out_f32, splits, ktps, s)         \
                         : launch_decode<MT, KIND, false>(x, w, scale, out, M, N, K, mode, \
                                                          out_f32, splits, ktps, s)
  switch (kind) {
    case kCodeE4M3: K1_DECODE(kCodeE4M3);
    case kCodeE5M2: K1_DECODE(kCodeE5M2);
    case kCodeInt8: K1_DECODE(kCodeInt8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_DECODE
}

// Sums the prefill kernel's split-K partials in split order, applies the
// scale and casts.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  void* __restrict__ out, int M, int N,
                                  int splits, int mode, int out_f32) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += partial[z * total + o];
  const int n = static_cast<int>(o % N);
  if (mode == kModeTensor) v *= scale[0];
  else if (mode == kModeChannel) v *= scale[n];
  if (out_f32) static_cast<float*>(out)[o] = v;
  else static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
}

// ---- the prefill kernel ----

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

constexpr int kPBN = 128;          // output columns per block
constexpr int kPBK = 64;           // contraction depth per stage
constexpr int kPStages = 4;        // TMA ring depth
constexpr int kPBufs = 3;          // bf16 weight-tile ring depth
constexpr int kPThreads = 288;     // two consumer warpgroups + one producer warp
constexpr int kPCodeBytes = kPBK * kPBN;      // one code tile
constexpr int kPTileBytes = kPBK * kPBN * 2;  // one bf16 weight tile (two 64-column chunks)

// Shared-memory layout of a block whose warpgroups own R slabs of 64 rows.
template <int R>
struct PSmem {
  static constexpr int BM = 2 * 64 * R;
  static constexpr int XB = BM * kPBK * 2;  // one x tile
  static constexpr int X = 0;
  static constexpr int C = X + kPStages * XB;
  static constexpr int W = C + kPStages * kPCodeBytes;
  static constexpr int BAR = W + kPBufs * kPTileBytes;
  static constexpr int BYTES = BAR + 2 * kPStages * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One e4m3 code (the top byte of `top`) → float by the FTZ route: its 7
// payload bits re-seated in the float pattern and one multiply by 2^120 with
// subnormal inputs flushed (mul.ftz), which turns the codes whose exponent
// field is 0 into ±0.
__device__ __forceinline__ float e4m3_top_to_float_ftz(uint32_t top) {
  const uint32_t bits = (top & 0x80000000u) | ((top >> 4) & 0x07F00000u);
  float v;
  asm("mul.ftz.f32 %0, %1, 0f7B800000;\n" : "=f"(v) : "f"(__uint_as_float(bits)));
  return v;
}

// 8 codes (one uint2) → 8 bf16 (one uint4), times the bf16 MX scales of
// the 8 columns at `s` (16-byte aligned, in device memory) if MX: each
// product in float, rounded once, as the plain version.
template <int KIND, bool MX>
__device__ __forceinline__ uint4 convert8(const uint2 codes, const __nv_bfloat16* s) {
  const uint32_t w[2] = {codes.x, codes.y};
  uint4 sv = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (MX) sv = __ldg(reinterpret_cast<const uint4*>(s));
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float f[4];
    if constexpr (KIND == kCodeE4M3) {
      f[0] = e4m3_top_to_float_ftz(w[i] << 24);
      f[1] = e4m3_top_to_float_ftz(w[i] << 16);
      f[2] = e4m3_top_to_float_ftz(w[i] << 8);
      f[3] = e4m3_top_to_float_ftz(w[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = weight_to_float<KIND>((w[i] >> (8 * j)) & 0xFFu);
    }
    if constexpr (MX) {
      f[0] *= bf16_lo(sw[2 * i]);
      f[1] *= bf16_hi(sw[2 * i]);
      f[2] *= bf16_lo(sw[2 * i + 1]);
      f[3] *= bf16_hi(sw[2 * i + 1]);
    }
    o[2 * i] = hopper::pack_bf16(f[0], f[1]);
    o[2 * i + 1] = hopper::pack_bf16(f[2], f[3]);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The tensor or channel scale of columns n, n + 1 (MX scales come before
// the dot).
template <bool MX>
__device__ __forceinline__ void scale_pair(float2& v, const void* __restrict__ scale_p, int mode,
                                           int n) {
  const float* scale = static_cast<const float*>(scale_p);
  if constexpr (!MX) {
    if (mode == kModeTensor) {
      v.x *= scale[0];
      v.y *= scale[0];
    } else {
      const float2 s = __ldg(reinterpret_cast<const float2*>(scale + n));
      v.x *= s.x;
      v.y *= s.y;
    }
  }
}

// Lane q of a quad holds row q of a 4x4 matrix in p; afterwards it holds
// column q (p[k] = the old p[q] of lane k).
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4], int q) {
  const int lane = threadIdx.x % 32;
  const bool b0 = q & 1, b1 = q & 2;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {  // swap the off-diagonal elements of 2x2 blocks
    const uint32_t y = __shfl_sync(0xffffffffu, b0 ? p[j] : p[j + 1], lane ^ 1);
    if (b0) p[j] = y;
    else p[j + 1] = y;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // swap the off-diagonal 2x2 blocks
    const uint32_t y = __shfl_sync(0xffffffffu, b1 ? p[j] : p[j + 2], lane ^ 2);
    if (b1) p[j] = y;
    else p[j + 2] = y;
  }
}

// A persistent block: it walks the output tiles blockIdx.x, + gridDim.x, ...
// (tile = (N tile, M tile, K split), N fastest), so the loads of a tile's
// first k tiles overlap the epilogue of the tile before.
template <int R, int KIND, bool MX>
__global__ void __launch_bounds__(kPThreads, 1)
qmm_prefill_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const void* __restrict__ scale, void* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int K, int mode, int out_f32,
                   int splits, int k_tiles_per_split) {
  using namespace hopper;
  using L = PSmem<R>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  auto full = [&](int s) { return base + L::BAR + 8u * s; };
  auto empty = [&](int s) { return base + L::BAR + 8u * (kPStages + s); };

  const int n_tiles = (N + kPBN - 1) / kPBN, m_tiles = (M + L::BM - 1) / L::BM;
  const int tiles = n_tiles * m_tiles * splits;
  const int k_tiles = (K + kPBK - 1) / kPBK;
  // The tile's origin and its k tiles [kt0, kt0 + nt).
  auto tile_at = [&](int tile, int& n0, int& m0, int& z, int& kt0, int& nt) {
    n0 = (tile % n_tiles) * kPBN;
    m0 = ((tile / n_tiles) % m_tiles) * L::BM;
    z = tile / (n_tiles * m_tiles);
    kt0 = z * k_tiles_per_split;
    nt = min(kt0 + k_tiles_per_split, k_tiles) - kt0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x == 256) {
      int g = 0;  // k tiles loaded so far (all tiles)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int n0, m0, z, kt0, nt;
        tile_at(tile, n0, m0, z, kt0, nt);
        for (int j = 0; j < nt; ++j, ++g) {
          const int s = g % kPStages, k0 = (kt0 + j) * kPBK;
          if (g >= kPStages) mbar_wait(empty(s), ((g / kPStages) - 1) & 1);
          mbar_arrive_expect_tx(full(s), L::XB + kPCodeBytes);
          tma_load_2d(base + L::X + s * L::XB, &tx, full(s), k0, m0);
          tma_load_2d(base + L::C + s * kPCodeBytes, &tw, full(s), n0, k0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64·R·wg .. + 64·R - 1 of a tile ----
  const int t = threadIdx.x, wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  // This thread's share of the dequantize: rows r0 .. r0 + 3 (one 32-row MX
  // block) of each code tile, 8 columns from c8·8, so that the 16-byte
  // writes of 8 neighbouring lanes fill one swizzled 128-byte row (no bank
  // conflicts).
  const int c8 = t % 16, r0 = (t / 16) * 4;
  float acc[R][64];
  int g = 0;  // k tiles consumed so far (all tiles)
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int n0, m0, z, kt0, nt;
    tile_at(tile, n0, m0, z, kt0, nt);

    // Dequantizes k tile j of this tile (stage and weight buffer of g + j).
    auto convert = [&](int j) {
      const int s = (g + j) % kPStages;
      mbar_wait(full(s), ((g + j) / kPStages) & 1);
      const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale);
      if constexpr (MX) {
        const int kb = min((kt0 + j) * kPBK + r0, K - 1) / 32;
        sc += static_cast<size_t>(kb) * N + min(n0 + c8 * 8, N - 8);
      }
      const unsigned char* codes = gbase + L::C + s * kPCodeBytes;
      unsigned char* tile_w =
          gbase + L::W + ((g + j) % kPBufs) * kPTileBytes + (c8 / 8) * (kPBK * 128);
      const int u = c8 % 8;  // 16-byte unit of the 128-byte row, before the swizzle
#pragma unroll
      for (int r = r0; r < r0 + 4; ++r) {
        const uint2 c = *reinterpret_cast<const uint2*>(codes + r * kPBN + c8 * 8);
        *reinterpret_cast<uint4*>(tile_w + r * 128 + ((u ^ (r & 7)) * 16)) =
            convert8<KIND, MX>(c, sc);
      }
      fence_proxy_async();  // the tile is read by wgmma (the async proxy)
    };

    auto issue = [&](int j) {
      const uint32_t xs = base + L::X + ((g + j) % kPStages) * L::XB;
      const uint32_t ws = base + L::W + ((g + j) % kPBufs) * kPTileBytes;
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPBK / 16; ++kk) {
        // B: rows 16kk.. of the MN-major tile; 64-column chunks 8192 bytes apart.
        const uint64_t db = make_desc(ws + kk * 16 * 128, kPBK * 128, 8 * 128, 128);
#pragma unroll
        for (int r = 0; r < R; ++r)
          wgmma_ss_n128_bt(acc[r], Tile<64>::kmajor(xs, L::BM, 64 * (R * wg + r), kk), db,
                           j > 0 || kk > 0);
      }
      wgmma_commit();
    };

    convert(0);
    consumers_sync();
    for (int j = 0; j < nt; ++j) {
      issue(j);
      if (j + 1 < nt) convert(j + 1);  // its buffer was last read by the products of j - 2
      wgmma_wait<1>();                 // the products of j - 1 are done
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      if (j >= 1 && t % 128 == 0) mbar_arrive(empty((g + j - 1) % kPStages));
      consumers_sync();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_regs(acc[r]);
    if (t % 128 == 0) mbar_arrive(empty((g + nt - 1) % kPStages));
    g += nt;

    // Epilogue: element i of a slab's accumulator is row 16·warp + lane/4 +
    // 8·((i >> 1) & 1), column 8·(i / 4) + 2·(lane % 4) + (i & 1).
    if (splits > 1 || out_f32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int m = m0 + 64 * (R * wg + r) + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
          const int n = n0 + 8 * (i / 4) + 2 * (lane % 4);
          if (m >= M || n >= N) continue;  // N is a multiple of 16: n + 1 < N too
          const size_t o = static_cast<size_t>(m) * N + n;
          float2 v = make_float2(acc[r][i], acc[r][i + 1]);
          if (splits > 1) {
            *reinterpret_cast<float2*>(partial + static_cast<size_t>(z) * M * N + o) = v;
            continue;
          }
          scale_pair<MX>(v, scale, mode, n);
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = v;
        }
      }
    } else {
      // bf16 out: the four lanes of a quad hold two columns each of every
      // 8-column group; a 4x4 transpose over the quad (two butterfly
      // exchanges) gives each lane one whole group, stored as 16 bytes.
      const int q = lane % 4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 64 * (R * wg + r) + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
          for (int gq = 0; gq < 4; ++gq) {
            uint32_t pk[4];  // pk[k]: this lane's pair of group 4·gq + k
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = 4 * (4 * gq + k) + 2 * h;
              float2 v = make_float2(acc[r][i], acc[r][i + 1]);
              scale_pair<MX>(v, scale, mode, min(n0 + 8 * (4 * gq + k) + 2 * q, N - 2));
              pk[k] = pack_bf16(v.x, v.y);
            }
            quad_transpose(pk, q);
            const int n = n0 + 8 * (4 * gq + q);
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                        static_cast<size_t>(m) * N + n) =
                  make_uint4(pk[0], pk[1], pk[2], pk[3]);
          }
        }
      }
    }
  }
}

template <int R, int KIND, bool MX>
int launch_prefill(const void* x, const void* w, const void* scale, void* out, float* partial,
                   int M, int N, int K, int mode, int out_f32, int splits, int ktps,
                   cudaStream_t s) {
  using L = PSmem<R>;
  CUtensorMap tx, tw;
  int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2LL * K, L::BM, kPBK, 128);
  if (e == 0)
    e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, N, kPBK, kPBN, 0);
  if (e != 0) return e;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      qmm_prefill_kernel<R, KIND, MX>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int tiles = ((N + kPBN - 1) / kPBN) * ((M + L::BM - 1) / L::BM) * splits;
  qmm_prefill_kernel<R, KIND, MX><<<min(tiles, num_sms()), kPThreads, L::BYTES, s>>>(
      tx, tw, scale, out, partial, M, N, K, mode, out_f32, splits, ktps);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_prefill_kind(int kind, int mode, const void* x, const void* w, const void* scale,
                        void* out, float* partial, int M, int N, int K, int out_f32,
                        int splits, int ktps, cudaStream_t s) {
#define K1_PREFILL(KIND)                                                                   \
  return mode == kModeMX                                                                   \
             ? launch_prefill<R, KIND, true>(x, w, scale, out, partial, M, N, K, mode,     \
                                             out_f32, splits, ktps, s)                     \
             : launch_prefill<R, KIND, false>(x, w, scale, out, partial, M, N, K, mode,    \
                                              out_f32, splits, ktps, s)
  switch (kind) {
    case kCodeE4M3: K1_PREFILL(kCodeE4M3);
    case kCodeE5M2: K1_PREFILL(kCodeE5M2);
    case kCodeInt8: K1_PREFILL(kCodeInt8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_PREFILL
}

}  // namespace

// The decode kernel, for any M and any shape: x [M, K] bf16 and w [K, N]
// codes row-major. scale: float32 (tensor, channel) or the bf16 MX scales
// [K/32, N]. splits (1, 2, 4 or 8) blocks of a cluster share each column
// tile, k_tiles_per_split 32-row k tiles each.
extern "C" int qmm_launch(const void* x, const void* w, const void* scale, void* out, int M,
                          int N, int K, int w_kind, int mode, int out_f32, int splits,
                          int k_tiles_per_split, void* stream) {
  if (splits < 1 || splits > 8 || (splits & (splits - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ktps = k_tiles_per_split;
  if (M <= 8)
    return launch_decode_kind<1>(w_kind, mode, x, w, scale, out, M, N, K, out_f32, splits,
                                 ktps, s);
  if (M <= 16)
    return launch_decode_kind<2>(w_kind, mode, x, w, scale, out, M, N, K, out_f32, splits,
                                 ktps, s);
  if (M <= 32)
    return launch_decode_kind<4>(w_kind, mode, x, w, scale, out, M, N, K, out_f32, splits,
                                 ktps, s);
  return launch_decode_kind<8>(w_kind, mode, x, w, scale, out, M, N, K, out_f32, splits, ktps,
                               s);
}

// The prefill kernel: x [M, K] bf16 and w [K, N] codes row-major and 16-byte
// aligned, K a multiple of 8 and N of 16 (TMA's stride rules). rows = 128 or
// 256 (rows of x per block). scale as qmm_launch's. With splits > 1,
// `partial` is a [splits, M, N] float32 workspace.
extern "C" int qmm_prefill_launch(const void* x, const void* w, const void* scale, void* out,
                                  void* partial, int M, int N, int K, int w_kind, int mode,
                                  int out_f32, int rows, int splits, int k_tiles_per_split,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  if (K % 8 != 0 || N % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int e = rows == 256
                    ? launch_prefill_kind<2>(w_kind, mode, x, w, scale, out, pp, M, N, K,
                                             out_f32, splits, k_tiles_per_split, s)
                    : launch_prefill_kind<1>(w_kind, mode, x, w, scale, out, pp, M, N, K,
                                             out_f32, splits, k_tiles_per_split, s);
  if (e != 0) return e;
  if (splits > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    qmm_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        pp, static_cast<const float*>(scale), out, M, N, splits, mode, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}
