// Packed meiosis: both gametes of every child, 32 loci per 32-bit word.
//
// Replaces geneevolve_tpu/ops/meiosis_packed_pallas.py `meiose_packed_pallas`
// and its layout experiments tools/kexp.py `meiose_v2` (split planes, no
// mutations) and `meiose_v3` (combined planes, no mutations). Per child c,
// gamete g (0 = from the father, 1 = from the mother) and word w:
//
//   child[c, g, w] = A ^ (mask & (A ^ B)) ^ mutation bits,
//   mask = (start[chr] & 1 ? ~0 : 0) XOR over the chromosome's crossovers x
//          of (~0 if w > x>>5; ~0 << (x & 31) if w == x>>5; else 0),
//
// with A, B the parent's two planes and x local to the chromosome. The
// planes are addressed by a base pointer per chromatid and a row stride, so
// the combined (N, 2, mw) layout (stride 2*mw, B at +mw) and the split
// (N, mw) x 2 layout of `meiose_v2` are the same kernel.
//
// Bound: memory. A child word needs its parent's word of one chromatid
// only, unless a crossover lies inside it, so a generation must move about
// 4 x n x mw x 4 bytes (a parent plane read and a child plane written per
// gamete), less where siblings share parents' words.
//
// Design: the work is cut into tiles aligned to chromosomes, a tile being
// (child, gamete, chromosome, span of words), in that order, so siblings'
// tiles (children sorted by couple sit next to each other) run close
// together and read their parents' words again while still in L2. A group
// of G threads owns a tile (G a power of two, 4..256): a warp holds 32 / G
// tiles, or a tile spans G / 32 warps. The host's launch plan
// (ops/meiose_packed.py `launch_plan`) picks G, the accesses a thread and
// the tiles a chromosome.
//
// Alignment. A child row of a chromosome (cw words) is cut where its own
// addresses cross 16 bytes: a head of at most 3 words up to its first
// 16-byte boundary, a body of 16-byte accesses (4 words, one streaming
// store each) and a tail of at most 3 words. Thread t of a group moves the
// tile's body accesses t, t + G, ..., at most kPerThread of them; the
// tile's head and tail words (at most 6: the first tile of a row holds the
// head, the last the tail) go one a thread, each word read from the plane
// its phase mask takes. A parent plane whose words lie at the child row's
// own 16-byte phase is copied one aligned vector an access. A plane at
// another phase (the B plane at +mw words when mw % 4 != 0, a row stride
// off 4 words, a window at another word offset than the child's) spans
// two aligned vectors an access, so a shifted launch stages each plane's
// vectors of a tile end to end, in access order, with one slot after the
// run: the access's own vector, which its lane copies, is followed by the
// next access's, which that access's lane copies where it takes the same
// plane (in this warp); where it does not, or where no next access
// exists, the lane copies the vector there itself. Each lane then takes
// its 4 words at the plane's shift; A and B may have different shifts.
// The launch plan says whether any child row can have a head or tail
// (`edges`) and whether any plane can be shifted (`shifted`), and the
// aligned launch compiles neither.
// Every chromosome length, row stride, pointer offset and window word
// offset thus keeps 16-byte copies and stores.
//
// Each warp copies its tiles' plan into its own slice of shared memory with
// asynchronous copies, 32 slots a copy instruction (the tiles' crossover
// rows end to end, then their gametes' mutation rows), and classifies it in
// place, 32 slots a pass, waiting at __syncwarp only: one ballot marks the
// crossovers whose word lies before their tile (their parity and the start
// chromatid give the tile's phase; the foreign slots of an earlier
// chromosome, whose local locus is negative, are among them), another those
// inside it, a third the mutations inside it; the ones inside are made
// relative to the tile's first body word (head words lie before it).
// Slots are not assumed sorted, nor a prefix: every slot is classified, as
// the plain version XORs every slot (a pad slot = m, or any slot past the
// chromosome, lies after the tile). A thread's phase at each of its
// accesses is then O(1) a word: each crossover of the tile flips the phase
// of the thread's accesses after it (a bit mask over its accesses). So the
// thread copies only the parent plane an access takes, both planes only
// where a crossover lies inside the access, and only such an access, or
// one that holds a mutation, takes the per-word path. Mutations flip per
// occurrence: a locus drawn twice cancels. Child words are written with
// streaming stores: nothing here reads them again.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // body accesses of a tile a thread moves
constexpr int kRows = 8;  // tiles a warp holds, at most
constexpr int kSlot = kPerThread * 32;  // staged vectors of a warp a kind
// shifted, a warp's vectors of a plane: its tiles' accesses end to end,
// each run (a tile, or a tile's 32 lanes at one access of a thread) with
// one vector after it
constexpr int kRegion = kSlot + 8;

struct Params {
  const uint32_t* a;  // chromatid A of parent row 0
  const uint32_t* b;  // chromatid B of parent row 0
  int64_t par_stride;
  uint32_t* out0;  // gamete 0 of child 0
  uint32_t* out1;  // gamete 1 of child 0
  int64_t out_stride;
  const int32_t* fathers;
  const int32_t* mothers;
  const int32_t* xo_p;
  const int32_t* st_p;
  const int32_t* xo_m;
  const int32_t* st_m;
  const int32_t* mu;  // null when km == 0
  int km, n_chr, K;
  int cw;  // words a chromosome
  int span;  // body accesses a tile: G x accesses a thread
  int per_thread;
  int splits;  // tiles a (child, gamete, chromosome) row
  int log_group;  // log2 G
  int tpw;  // tiles a warp: 32 / G, or 1
  int n_tiles;
  int plan_words;  // shared words of a warp's plan (a multiple of 4)
  int warp_words;  // shared words a warp: its plan, then its parent words
};

struct Tile {
  int child, g, ch, s;  // child, gamete, chromosome, span of the chromosome
};

__device__ __forceinline__ Tile tile_at(int tile, const Params& p) {
  int u = tile, s = 0;
  if (p.splits > 1) {
    u = tile / p.splits;
    s = tile - u * p.splits;
  }
  const int gc = u / p.n_chr;
  return Tile{gc >> 1, gc & 1, u - gc * p.n_chr, s};
}

// the child row of a tile's chromosome
__device__ __forceinline__ uint32_t* child_row(const Tile& u,
                                               const Params& p) {
  return (u.g ? p.out1 : p.out0) + u.child * p.out_stride +
         (int64_t)u.ch * p.cw;
}

// words of a row before its first 16-byte boundary (the head), at most cw
__device__ __forceinline__ int head_words(const uint32_t* row, int cw) {
  return min((int)((4 - ((uintptr_t)row >> 2)) & 3), cw);
}

// the 16-byte vector holding word `w`, and w's place in it
__device__ __forceinline__ const uint4* vec_of(const uint32_t* w) {
  return reinterpret_cast<const uint4*>((uintptr_t)w & ~(uintptr_t)15);
}
__device__ __forceinline__ int shift_of(const uint32_t* w) {
  return (int)(((uintptr_t)w >> 2) & 3);
}

// Asynchronous 16-byte copies into shared memory (no registers held while
// in flight), and 4-byte ones for the plan's slots
__device__ __forceinline__ void copy_async(void* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(void* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// wait for every copy this thread has issued
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void words_of(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// o's 4 words and the vector after them, `shift` (1..3) words on
__device__ __forceinline__ void shift_in(uint32_t* o, const uint4& next,
                                         int shift) {
  uint32_t w[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = o[c];
  words_of(next, w + 4);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o[c] = shift == 1 ? w[c + 1] : (shift == 2 ? w[c + 2] : w[c + 3]);
}

// A warp's plan, flat: its tile r's K crossover slots at fx[r K ...] and
// its gamete's km mutation slots at fm[r km ...]; bit b of mask word w
// marks flat slot 32 w + b: inside its tile (`x_in`, `m_in`) or, for a
// crossover, before it (`x_before`).
__device__ __forceinline__ uint32_t range_bits(int w, int lo, int n) {
  const int a = max(lo - 32 * w, 0), b = min(lo + n - 32 * w, 32);
  return (b == 32 ? GE_FULL : (1u << b) - 1) & ~((1u << a) - 1);
}

// f(flat slot) for every bit of `masks` set in the flat slots [lo, lo + n)
template <typename F>
__device__ __forceinline__ void for_each(const uint32_t* masks, int lo, int n,
                                         F f) {
  for (int w = lo >> 5; w < (lo + n + 31) >> 5; ++w)
    for (uint32_t m = masks[w] & range_bits(w, lo, n); m; m &= m - 1)
      f(32 * w + __ffs(m) - 1);
}

// the row of flat slot f of rows of n slots: floor(f / n), exactly
__device__ __forceinline__ int row_of(int f, int n, float inv_n) {
  int r = (int)((f + 0.5f) * inv_n);
  r -= r * n > f;
  r += (r + 1) * n <= f;
  return r;
}

template <typename T>
__device__ __forceinline__ T* shfl_ptr(T* ptr, int lane) {
  return reinterpret_cast<T*>(__shfl_sync(
      GE_FULL, reinterpret_cast<unsigned long long>(ptr), lane));
}

template <bool kEdge, bool kShift>
__global__ void __launch_bounds__(kThreads)
    meiose_packed_kernel(const Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = 1 << p.log_group;
  const int first = blockIdx.x * (kThreads >> p.log_group) +
                    ((warp * 32) >> p.log_group);
  const int rows = min(p.tpw, p.n_tiles - first);  // the warp's tiles
  if (rows <= 0) return;
  const int mine = p.tpw > 1 ? lane >> p.log_group : 0;  // the lane's tile
  const int t = threadIdx.x & (group - 1);
  const Tile tl = tile_at(first, p);
  // the warp's tile r: past the first only where a tile is a whole
  // chromosome (splits == 1)
  auto tile_of = [&](int r) -> Tile {
    int ch = tl.ch + r, gc = 2 * tl.child + tl.g;
    while (ch >= p.n_chr) {
      ch -= p.n_chr;
      ++gc;
    }
    return Tile{gc >> 1, gc & 1, ch, tl.s};
  };
  const Tile own = tile_of(mine);
  const bool active = mine < rows;
  const bool last = tl.s == p.splits - 1;  // the warp's tiles end their rows

  // the warp's slice of shared memory: its plan (layout above), then its
  // lanes' parent vectors: aligned, [kind][access][lane], kind 0 the plane
  // an access takes (A where it takes both), kind 1 B where it takes both;
  // shifted, [plane][run slot] (kRegion vectors a plane), an access's
  // slot followed by its successor's (the next access of the tile)
  const int wx = (kRows * p.K + 31) >> 5, wm = (kRows * p.km + 31) >> 5;
  int32_t* wsm = smem + warp * p.warp_words;
  int32_t* st = wsm;  // [kRows] start chromatids
  uint32_t* x_before = reinterpret_cast<uint32_t*>(st + kRows);
  uint32_t* x_in = x_before + wx;
  uint32_t* m_in = x_in + wx;
  int32_t* fx = reinterpret_cast<int32_t*>(m_in + wm);
  int32_t* fm = fx + kRows * p.K;
  uint4* buf = reinterpret_cast<uint4*>(wsm + p.plan_words);

  // 1. the plan, copied as it is: lane r takes tile r's start chromatid
  // and keeps its rows' addresses and its first body word (past its
  // child row's head); the slots follow, 32 a copy instruction
  const int chr_len = 32 * p.cw;
  const int32_t* xrow = p.xo_p;
  const int32_t* mrow = p.mu;
  int base = 0;  // the first global locus of lane r's tile's chromosome
  int org = 0;  // lane r's tile's first body word, local to the chromosome
  if (lane < rows) {
    const Tile u = tile_of(lane);
    const int64_t row = (int64_t)u.child * p.n_chr + u.ch;
    xrow = (u.g ? p.xo_m : p.xo_p) + row * p.K;
    mrow = p.mu + ((int64_t)u.child * 2 + u.g) * p.km;
    base = u.ch * chr_len;
    if (kEdge) org = head_words(child_row(u, p), p.cw) + 4 * u.s * p.span;
    copy_async(st + lane, (u.g ? p.st_m : p.st_p) + row);
  }
  int64_t par = 0;
  if (active) par = (own.g ? p.mothers : p.fathers)[own.child];
  const int n_x = rows * p.K, n_m = rows * p.km;
  const float inv_k = 1.0f / p.K, inv_km = 1.0f / p.km;
  for (int f0 = 0; f0 < n_x; f0 += 32) {
    const int f = f0 + lane, r = row_of(min(f, n_x - 1), p.K, inv_k);
    const int32_t* src = shfl_ptr(xrow, r) + (f - r * p.K);
    if (f < n_x) copy_async(fx + f, src);
  }
  for (int f0 = 0; f0 < n_m; f0 += 32) {
    const int f = f0 + lane, r = row_of(min(f, n_m - 1), p.km, inv_km);
    const int32_t* src = shfl_ptr(mrow, r) + (f - r * p.km);
    if (f < n_m) copy_async(fm + f, src);
  }

  // 2. classify the plan in place, 32 slots a pass: a crossover's local
  // locus (wrapping as the plain version's int32 subtraction does) before
  // the tile or inside it, there made relative to the tile's first body
  // word; a mutation inside the tile, likewise. A tile holds the loci of
  // its body words, and the head's (first tile) or the tail's (last tile).
  wait_copies();
  __syncwarp();
  const int body = 4 * p.span;  // words of a whole tile's body
  for (int f0 = 0; f0 < n_x; f0 += 32) {
    const int f = f0 + lane, r = row_of(min(f, n_x - 1), p.K, inv_k);
    const int b = __shfl_sync(GE_FULL, base, r);
    const int o = kEdge ? __shfl_sync(GE_FULL, org, r) : tl.s * body;
    const int lo = tl.s ? 32 * o : 0;
    const int hi = last ? chr_len : 32 * (o + body);
    const int xl = f < n_x ? (int)((uint32_t)fx[f] - (uint32_t)b) : INT_MAX;
    const bool in = xl >= lo && xl < hi;
    const uint32_t before = __ballot_sync(GE_FULL, xl < lo);
    const uint32_t inside = __ballot_sync(GE_FULL, in);
    if (in) fx[f] = xl - 32 * o;
    if (lane == 0) {
      x_before[f0 >> 5] = before;
      x_in[f0 >> 5] = inside;
    }
  }
  for (int f0 = 0; f0 < n_m; f0 += 32) {
    const int f = f0 + lane, r = row_of(min(f, n_m - 1), p.km, inv_km);
    const int b = __shfl_sync(GE_FULL, base, r);
    const int o = kEdge ? __shfl_sync(GE_FULL, org, r) : tl.s * body;
    const int lo = b + (tl.s ? 32 * o : 0);
    const int hi = b + (last ? chr_len : 32 * (o + body));
    const int m = f < n_m ? fm[f] : -1;
    const bool in = m >= lo && m < hi;
    const uint32_t inside = __ballot_sync(GE_FULL, in);
    if (in) fm[f] = m - b - 32 * o;
    if (lane == 0) m_in[f0 >> 5] = inside;
  }
  __syncwarp();
  if (!active) return;

  // 3. the lane's phase: its tile's start chromatid XOR the parity of the
  // crossovers before the tile; bit i of `flips` the parity of the tile's
  // crossovers before access i (a head word's lie before every access),
  // of `cross` and `mut` an access that holds a crossover or a mutation;
  // shifted, `flips_n` and `cross_n` the same of each access's successor
  // (access j + 1: thread t + 1's access i, or thread 0's i + 1)
  const int xlo = mine * p.K, mlo = mine * p.km;
  const int w0 = 4 * t;  // the thread's first body word, tile-relative
  const int lp = p.log_group + 2;  // log2 words apart
  int phase = st[mine];
  for (int w = xlo >> 5; w < (xlo + p.K + 31) >> 5; ++w)
    phase ^= __popc(x_before[w] & range_bits(w, xlo, p.K));
  uint32_t flips = 0, cross = 0, mut = 0, flips_n = 0, cross_n = 0;
  for_each(x_in, xlo, p.K, [&](int f) {
    const int d = (fx[f] >> 5) - w0;
    const int q = d >> lp;  // floor: accesses after q lie past it
    flips ^= 0xFFu << (q + 1);
    if (q >= 0 && d - (q << lp) < 4) cross |= 1u << q;
    if (kShift) {
      const int dn = d - 4, qn = dn >> lp;
      flips_n ^= 0xFFu << max(qn + 1, 0);
      if (qn >= 0 && dn - (qn << lp) < 4) cross_n |= 1u << qn;
    }
  });
  for_each(m_in, mlo, p.km, [&](int f) {
    const int d = (fm[f] >> 5) - w0;
    const int q = d >> lp;
    if (q >= 0 && d - (q << lp) < 4) mut |= 1u << q;
  });

  // 4. the child row's cut, and the parent's vectors the lane's accesses
  // take: the one plane its phase selects, both planes where a crossover
  // lies inside the access. Bit i of `live`: access i exists; of `both`:
  // it takes both planes; of `take_b`: it takes B alone.
  const int64_t word0 = (int64_t)own.ch * p.cw;
  const uint32_t* ra = p.a + par * p.par_stride + word0;
  const uint32_t* rb = p.b + par * p.par_stride + word0;
  uint32_t* ro = child_row(own, p);
  const int hd = kEdge ? head_words(ro, p.cw) : 0;
  const int nbody = (p.cw - hd) >> 2;  // body accesses of the row
  const int sa = kShift ? shift_of(ra + hd) : 0;
  const int sb = kShift ? shift_of(rb + hd) : 0;
  const uint4* va = vec_of(ra + hd);
  const uint4* vb = vec_of(rb + hd);
  const int j_lo = own.s * p.span + t;  // the thread's first access
  const int j_hi = min(nbody, (own.s + 1) * p.span);
  uint32_t live = 0, take_b = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j_lo + (i << p.log_group);
    if (i < p.per_thread && j < j_hi) {
      live |= 1u << i;
      if (!((cross >> i) & 1) && ((phase ^ (int)(flips >> i)) & 1))
        take_b |= 1u << i;
    }
  }
  const uint32_t both = cross & live;
  // the slot of access i: aligned, [kind][i][lane]; shifted, the access's
  // place in its run, planes kRegion apart
  const int run0 = group <= 32 ? mine * (p.span + 1) + t : lane;
  const int run_step = group <= 32 ? group : 33;
  auto slot_of = [&](int i) -> uint4* {
    return kShift ? buf + run0 + i * run_step : buf + i * 32 + lane;
  };
  const int kind_b = kShift ? kRegion : kSlot;  // B's slots past A's
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (!((live >> i) & 1)) continue;
    const int j = j_lo + (i << p.log_group);
    const bool bo = (both >> i) & 1, tb = (take_b >> i) & 1;
    uint4* slot = slot_of(i);
    copy_async(slot + (kShift && tb ? kind_b : 0), (tb ? vb : va) + j);
    if (bo) copy_async(slot + kind_b, vb + j);
    if (kShift) {
      // a plane at a shift also takes the vector after the access's own:
      // its successor stages it where it takes that plane (in this warp),
      // else this lane copies it into the successor's slot of the plane
      const bool n_in = (group <= 32 || lane < 31) && j + 1 < j_hi;
      const bool n_both = n_in && ((cross_n >> i) & 1);
      const bool n_b = ((phase ^ (int)(flips_n >> i)) & 1) != 0;
      const bool n_a_staged = n_in && (n_both || !n_b);
      const bool n_b_staged = n_in && (n_both || n_b);
      if (sa && (bo || !tb) && !n_a_staged) copy_async(slot + 1, va + j + 1);
      if (sb && (bo || tb) && !n_b_staged)
        copy_async(slot + kind_b + 1, vb + j + 1);
    }
  }

  // the tile's head and tail words, one a thread (at most 6 of them, and
  // G >= 4): each word's phase mask from the crossovers before it and in
  // it; only the planes the mask takes are read, while the copies fly
  int ew[2] = {-1, -1};  // the edge words, local to the chromosome
  uint32_t ev[2];  // their values
  if (kEdge) {
    const int org0 = hd + 4 * own.s * p.span;  // the tile's first body word
    const int n_head = own.s == 0 ? hd : 0;
    const int n_tail = last ? p.cw - hd - 4 * nbody : 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = t + k * group;
      if (e >= n_head + n_tail) continue;
      ew[k] = e < n_head ? e : p.cw - n_tail + (e - n_head);
      const int er = ew[k] - org0;  // relative to the first body word
      uint32_t mask = (phase & 1) ? GE_FULL : 0u;
      for_each(x_in, xlo, p.K, [&](int f) {
        const int xw = fx[f] >> 5;
        if (xw < er) mask = ~mask;
        else if (xw == er) mask ^= GE_FULL << (fx[f] & 31);
      });
      const uint32_t a = mask != GE_FULL ? ra[ew[k]] : 0u;
      const uint32_t b = mask != 0u ? rb[ew[k]] : 0u;
      ev[k] = a ^ (mask & (a ^ b));
      for_each(m_in, mlo, p.km, [&](int f) {
        if ((fm[f] >> 5) == er) ev[k] ^= 1u << (fm[f] & 31);
      });
    }
  }
  wait_copies();
  if (kShift) {  // the successors' copies, visible to the warp's lanes
    const int n_lanes = rows << p.log_group;  // lanes of the warp's tiles
    __syncwarp(n_lanes >= 32 ? GE_FULL : (1u << n_lanes) - 1);
  }

  // 5. the child's body words, then its edge words
  uint4* vo = reinterpret_cast<uint4*>(ro + hd);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (!((live >> i) & 1)) continue;
    const int j = j_lo + (i << p.log_group);
    const bool bo = (both >> i) & 1, tb = (take_b >> i) & 1;
    const uint4* slot = slot_of(i);
    const uint4* own_v = slot + (kShift && tb ? kind_b : 0);
    uint32_t o[4];
    words_of(own_v[0], o);
    if (kShift && (tb ? sb : sa)) shift_in(o, own_v[1], tb ? sb : sa);
    const int s0 = w0 + (i << lp);  // the access's first word
    if (bo) {  // A here, B beside it: select per word
      uint32_t b[4], m[4];
      words_of(slot[kind_b], b);
      if (kShift && sb) shift_in(b, slot[kind_b + 1], sb);
      const uint32_t full = ((phase ^ (int)(flips >> i)) & 1) ? GE_FULL : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) m[c] = full;
      for_each(x_in, xlo, p.K, [&](int f) {
        const int e = (fx[f] >> 5) - s0;  // earlier ones are in `flips`
        if (e < 0 || e >= 4) return;
        const uint32_t part = GE_FULL << (fx[f] & 31);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          m[c] ^= c > e ? GE_FULL : (c == e ? part : 0u);
      });
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] ^= m[c] & (o[c] ^ b[c]);
    }
    if ((mut >> i) & 1) {
      for_each(m_in, mlo, p.km, [&](int f) {
        const int e = (fm[f] >> 5) - s0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c == e) o[c] ^= 1u << (fm[f] & 31);
      });
    }
    __stcs(vo + j, make_uint4(o[0], o[1], o[2], o[3]));
  }
  if (kEdge) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (ew[k] >= 0) __stcs(ro + ew[k], ev[k]);
  }
}

template <bool kEdge, bool kShift>
int launch(const Params& p, int64_t blocks, int smem, cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB, and a
  if (!configured) {               // carve-out that fits several blocks
    cudaFuncSetAttribute(meiose_packed_kernel<kEdge, kShift>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    cudaFuncSetAttribute(meiose_packed_kernel<kEdge, kShift>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    configured = true;
  }
  meiose_packed_kernel<kEdge, kShift>
      <<<dim3((unsigned)blocks), kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a_plane/b_plane: chromatid A/B of parent row 0, rows `par_stride` words
// apart; out0/out1: gamete 0/1 of child 0, rows `out_stride` words apart;
// fathers/mothers (n,) int32; xo_p/xo_m (n, n_chr, K) int32 global loci
// (pad = m); st_p/st_m (n, n_chr) int32; mu (n, 2, km) int32 or null. The
// launch plan (edges, shifted, log_group, per_thread, splits, blocks,
// smem) is the host's `launch_plan` for these shapes, strides and pointer
// offsets.
GE_API int ge_meiose_packed(const void* a_plane, const void* b_plane,
                            int64_t par_stride, void* out0, void* out1,
                            int64_t out_stride, const void* fathers,
                            const void* mothers, const void* xo_p,
                            const void* st_p, const void* xo_m,
                            const void* st_m, const void* mu, int km,
                            int64_t n, int n_chr, int K, int cw, int edges,
                            int shifted, int log_group, int per_thread,
                            int splits, int64_t blocks, int smem,
                            void* stream) {
  if (blocks == 0) return (int)cudaGetLastError();
  Params p{(const uint32_t*)a_plane, (const uint32_t*)b_plane, par_stride,
           (uint32_t*)out0, (uint32_t*)out1, out_stride,
           (const int32_t*)fathers, (const int32_t*)mothers,
           (const int32_t*)xo_p, (const int32_t*)st_p, (const int32_t*)xo_m,
           (const int32_t*)st_m, (const int32_t*)mu, km, n_chr, K, cw};
  p.per_thread = per_thread;
  p.span = per_thread << log_group;
  p.splits = splits;
  p.log_group = log_group;
  p.tpw = log_group < 5 ? 32 >> log_group : 1;
  p.n_tiles = (int)(n * 2 * n_chr * splits);
  p.plan_words = kRows + 2 * ((kRows * K + 31) / 32) +
                 (kRows * km + 31) / 32 + kRows * (K + km);
  p.plan_words = (p.plan_words + 3) & ~3;  // the parent words are 16-byte
  p.warp_words = p.plan_words + 2 * (shifted ? kRegion : kSlot) * 4;
  if ((int64_t)smem < 4 * (kThreads / 32) * (int64_t)p.warp_words)
    return (int)cudaErrorInvalidValue;  // the host sized another layout
  cudaStream_t s = (cudaStream_t)stream;
  if (shifted)
    return edges ? launch<true, true>(p, blocks, smem, s)
                 : launch<false, true>(p, blocks, smem, s);
  return edges ? launch<true, false>(p, blocks, smem, s)
               : launch<false, false>(p, blocks, smem, s);
}
