// Trilinear sampling of a volume. For the render: the values with the
// analytic gradient of channel 0, forward (trilinear_cf_with_grad_fwd) and
// the volume's cotangent (trilinear_bwd). For the occupancy eval, the
// uniform sdf grid and the compact second derivative: the values alone,
// forward (trilinear_cf_fwd) and the volume's cotangent
// (trilinear_cf_bwd), with kernels of their own (the values-only pair,
// below).
//
// Replaces: selfocc_tpu/ops/interp.py::trilinear_sample_cf_with_grad
// (interp.py:159), which XLA lowers on the TPU to 8 corner gathers over a
// flattened (C, H*W*D) volume, and its JAX autodiff cotangent; and, values
// only, interp.py::trilinear_sample_cf (:118, the dense occupancy query,
// the KITTI uniform sdf grid and sdf taps) and interp.py::trilinear_sample
// (:73, the Occ3D resample of the dense sdf and logits grids), with their
// cotangents; and the flow head's lookup, interp.py::trilinear_sample_cf
// with "border" padding (:131-150, called at selfocc_tpu/models/
// heads.py:519-520). Semantics:
// align_corners=True fractional (h, w, d) indices, zeros padding (the
// narrow instances: either padding, below); vals
// (N, C) = sum over the 8 corners of weight * value; grad0 (N, 3) =
// d(channel 0)/d(h, w, d), the bilinear interpolation over the other two
// axes of the corner differences along each axis. The backward adds, for
// every in-volume corner k of a point, gv[c] * w_k to channel c and
// sum_j gg[j] * dw_k/dx_j to channel 0 (the derivative of the closed-form
// gradient with respect to the corner value). The point-free instances
// give the points no cotangent; the point instances (trilinear_bwd_points,
// trilinear_cf_bwd_points: the NeuS importance rounds place samples whose
// positions carry a gradient) also write the cotangent of each point's
// fractional indices, as JAX autodiff gives it (point_cotangent).
//
// Layout. The kernels read a channel-last volume, (H, W, D, C) in memory:
// a corner's C channels are one contiguous row (100 bytes at C = 25). The
// public op keeps the JAX package's (C, H, W, D) shape and takes this
// layout as a permuted view, which is what the field's decode produces;
// with C = 1 it is the plain (H, W, D) plane.
//
// What bounds them on the H100. The render calls them on the samples of
// whole rays, ray-major: 256 samples per ray about 0.2 cells apart, so runs
// of about five consecutive points share one cell and all 8 of its corners.
// Per training chunk (4096 rays, 1M points) there is one call at C = 25 on
// the 165 MB decoded volume and six at C = 1 on the 6.6 MB sdf plane, which
// stays in L2; the eval frame calls C = 1 on 8.4M points per chunk.
// - The C = 25 backward was bound by its atomics: one scalar atomic per
//   (point, corner, channel), 200 per point, each on its own cache line of
//   a channel-first gradient.
// - The C = 25 forward read 200 scattered 4-byte words per point, one
//   sector each, from a volume larger than L2.
// - Once those go, the function's own bytes are a few tens of MB per call
//   and most corner rows are hits in L1 or L2; the design then counts load,
//   shared-memory and atomic requests per point, not HBM bytes.
//
// Design. Each kernel has two instances: "plane" for C = 1, "rows" for
// C > 1. A warp takes 32 consecutive points; a run is a stretch of
// consecutive points in one cell. Nothing assumes that points come in
// runs: uniform, shuffled or padded points make runs of one point, and
// the result is the same.
// - Rows forward: each point's own lane computes its cell, its corner
//   mask and grad0 (from channel 0 of its corners); then lanes over
//   channels walk the warp's points in order and keep the 8 corner rows of
//   the current cell in registers, loaded again only when the cell
//   changes. A corner row is one coalesced warp load (100 bytes at
//   C = 25); vals (N, C) are written as contiguous rows.
// - Rows backward: lanes over channels walk the points in order and sum a
//   run's contributions to each of the cell's 8 corners in registers;
//   when the cell changes, each corner row it leaves takes one atomic per
//   lane (4 on a step into a neighbouring cell, whose 4 shared corners
//   carry their sums over), so a run costs about 4 row updates of 4-5
//   sectors, against 200 scattered atomics per point before. The gradient
//   is accumulated channel-last and needs no transpose (decode's permute
//   takes it as it is).
// - Plane backward: one lane per point. A voxel's contributions from
//   consecutive points are chained through shared memory (each point
//   notes the voxel's slot in the next point, if that point's cell
//   touches it), and the chain's first lane sums it and makes one scalar
//   atomic into the L2-resident plane. Chains, unlike runs, go on across
//   steps into neighbouring cells.
// - Plane forward: one lane per point and 8 scalar loads, which hit L2.
// Tried on the card and dropped, slower at the training chunk's points: an
// 8-byte load of the two corners adjacent along d in the plane forward
// (lanes of one warp differ in alignment, and the two paths serialise);
// carrying 4 rows across a step in the rows forward (the register moves
// cost more than the 4 loads, which hit L1); runs with a segmented shuffle
// reduction in the plane backward (a run flushes all 8 corners, a chain
// one per voxel); chains in the rows kernels.
// - Both forwards stage grad0 through shared memory, so the warp writes its
//   32 x 3 floats with three coalesced stores.
//
// The values-only pair. Its callers: the dense occupancy query (C = 25,
// 10.5M points of a 512 x 512 x 40 grid, 0.5-0.6 cells apart), the Occ3D
// resample (C = 21 and the sdf plane, both at row stride 25, 640,000
// points about 2 cells apart), the kitti_occ uniform sdf grid (C = 4 at
// row 4, 262,144 jittered points, each in a cell of its own), the
// compact second derivative (C = 1: the six taps of each of a chunk's
// 1,048,576 samples as one point-major query, forward and backward) and
// the flow head's border lookup (C = 3, 12-byte rows of a (257, 257, 25,
// 3) flow, 19.8 MB, at a step's 7,372,800 ray samples: about 16 runs of
// one cell in a warp's 32, none clipped, as the samples lie in the
// volume's box). A sample's six taps lie 0.05 of a cell apart, in one cell
// 73% of the time; consecutive samples about one cell apart, so the 32
// taps of a warp fall in about 9 runs of one cell.
// - "border" padding (the narrow instances alone; the launchers refuse it
//   at C > 3): each index clipped to [0, size - 1] in the kernel, the
//   upper corners clamped onto the face rows, where their weight is 0;
//   the points' cotangent takes the clip's derivative as JAX autodiff
//   gives jnp.clip's (a maximum, then a minimum: 1 inside, 0.5 at a tie,
//   0 outside).
// - Narrow forward, C <= 3 (but C = 1 with zeros padding, the plane's):
//   one thread per point, its 8 x C scalar loads issued before the sum
//   (the flow stays in L2), the warp's 32 x C values staged through shared
//   memory for C coalesced stores. Until then C = 3 took the walk below,
//   whose lanes over channels left 29 of 32 idle and walked the warp's 32
//   points one after another, after a clip in torch of 11-12 launches.
// - Narrow backward, C <= 3: lanes over points; consecutive lanes whose
//   points share a cell sum their 8 x C contributions by a segmented
//   shuffle scan (as the plane's, with only as many steps as the warp's
//   longest segment needs); each segment's last lane makes one float4
//   atomic a corner row into a zeroed (H, W, D, 4) scratch, none for a row
//   of exact zeros, and narrow_fold_kernel writes the (H, W, D, C)
//   gradient from it (a 12-byte row is 16-byte aligned at no voxel). The
//   point instance also gives each point its cotangent from its own 8
//   corner rows. Runs are short (about 2 points), so the atomics bound it
//   (the kernel without them, a probe: 0.124 of 0.55 ms): a float4 atomic
//   carries a row in one request where scalar atomics took C. Tried and
//   slower at the flow step's points (tools/trilinear_scatter_variants.py,
//   device ms in one call): C scalar atomics straight into the gradient
//   (1.45 against 0.55), a float2 on the row's 8-byte-aligned pair and a
//   scalar (1.02), no segments, each lane its own 8 float4 atomics (1.08),
//   the block's shared-memory table of the C = 1 segments before float4
//   atomics (0.60), and chains of consecutive segments that share a voxel,
//   summed through a warp table in shared memory before one float4 atomic
//   a chain (0.58: about half the atomics, and no faster). The crowded
//   cells of that step (at most 10,704 points) keep fp32 atomics: the
//   volume's cotangent stays within GRAD_RTOL of the plain version.
// - Rows forward, 3 < C <= 32 (walk): as the render's, lanes over channels
//   walk the warp's 32 points and reload the 8 corner rows only when the
//   cell changes; each point's row is stored as it is. At the dense query
//   the bound is the 1.05 GB of values (0.38 ms over HBM); the walk takes
//   2.6x that, and staging its rows for float4 stores made it slower, so
//   the row stores are not what bounds it (what does is not measured:
//   the card has no profiler of its own; the walk reloads 8 corner rows
//   from L2 at every cell change). Tried and slower there: lanes over the
//   tile's (point, channel) pairs, each pair's 8 loads independent, the
//   tile staged for float4 stores (1.5x the walk: every pair loads its 8
//   corners, where the walk keeps a cell's rows for its next points), and
//   the walk with its values staged.
// - Rows forward, C > 32 (pairs): the (point, channel) pairs of a tile of
//   up to 128 points, its values staged in shared memory for float4
//   stores.
// - Rows forward, C = 4 at 16-byte rows (vec4): one thread per point, a
//   float4 load per corner row and one float4 store: 4x fewer load
//   requests than lanes over channels, and no walk (every point of the
//   uniform grid has a cell of its own).
// - Plane forward: one thread per point, its 8 loads issued before the
//   sum; a sample's taps on neighbouring lanes read their corners from L1.
// - Rows backward, C a multiple of 4 with 16-byte-aligned cotangent and
//   gradient (vec4): one thread per (point, 4 channels), one float4
//   atomicAdd per in-volume corner row (8 a point at C = 4, compute
//   capability 9.x).
// - Rows backward, any other C > 3 (walk): as the render's rows backward,
//   lanes over channels walk the warp's 32 points, sum each run of one
//   cell in 8 registers and carry the 4 shared corner rows across a unit
//   step; each row it leaves takes one scalar atomic a lane, none where
//   the lane's sum is an exact zero. Its callers are C = 25: the density
//   step's one query (7,372,800 ray samples), the options step's
//   numerical-gradient query (a 1,048,576-sample chunk, 9 a step) and the
//   BEV step's uniform sdf grid (640,000 jittered points, the sdf channel
//   alone live); see "The two C = 25 scatters" below.
// - Plane backward (segments): no serial walk. A warp's lanes whose points
//   lie in one cell (consecutive lanes) sum their 8 contributions by a
//   segmented scan of 5 shuffle steps; each segment's last lane puts the
//   in-volume corners into the block's hash table in shared memory (open
//   addressing, 1024 slots, 8 probes, then a global atomic), which the
//   block flushes with one global atomic per occupied slot after its 4
//   tiles of 256 points. Uniform, shuffled or out-of-volume points make
//   segments of one point and fill the table; the rest go straight to
//   global atomics, and the result is the same. Tried and slower: the
//   table alone (32-way conflicts on a slot), __match_any_sync peer sums
//   before the table, larger tables over more tiles, and global atomics
//   straight from the segments (the chunk's taps touch few voxels, tens
//   of thousands, so those atomics queue on the same addresses). The
//   table takes 8 inserts, each an fp32 atomicAdd in shared memory, for
//   every run of one cell in a warp (chip_smoke.py records the runs per
//   warp and the voxels touched).
// The point instances also give the points their cotangent: at C = 1
// (both the with-grad and the values-only one) from each point's own lane,
// which reads its 8 corners (below); C > 1 from the walks, as below
// (values-only: the walk above at C > 3, no caller on a shipped path; the
// narrow instance at C <= 3).
// The C = 1 point instances (trilinear_plane_points_bwd), one design for
// both: the importance step's merged render (its six second-derivative
// taps, with grad0, on the contiguous sdf plane) and its rounds' sdf
// queries (values only, channel 0 read in place at row stride 25), 4096 x
// 272 .. 320 ray-major points a call. The segments above (plane_seg), each
// lane loading its own 8 corners for the point's cotangent (lanes of one
// cell load the same words in one request), the sums flushed with fp64
// atomics into one zeroed fp64 (H, W, D) plane (13.2 MB at 257 x 257 x 25,
// L2-resident), which trilinear_plane_fold_kernel rounds into the fp32
// gradient once: a fill and two kernels a call, where the fp32 chains and
// segments with fp64 rows for crowded cells that the C > 1 instances keep
// took 7 launches (a count pre-pass over the points, an int32 count per
// voxel, key and row fills, a fold). The
// step's own points hold cells of 60,000-190,000 points around the camera;
// the plane holds their sums in fp64 with no count or probe. Tried and
// slower at those points and at uniform stand-ins (chip_smoke.py [head],
// tools/trilinear_scatter_variants.py): the with-grad instance by the
// point-free kernel's chains (1.33x on the stand-ins, 1.62x on the step's
// taps: a run of 32 points in one cell makes one lane walk 8 chains of
// 32), the segment's first lane loading the corners and shuffling them to
// the rest (1.06-1.12x), blocks sized to one wave of resident blocks by
// the occupancy calculator (1.08-1.15x) or taking 1, 2 or 8 tiles
// (1.01-1.20x), and fp64 atomics straight from the segments without the
// block's table (1.55-1.73x).
// The two C = 25 scatters. Both put 25-channel cotangent rows (100 bytes,
// 16-byte aligned only at every fourth voxel) into the (H, W, D, 25)
// gradient of the decoded volume. What bounds them is the atomics: a
// warp's scalar atomic on a corner row touches its 4-5 sectors whatever
// the width of the lanes' values, and a sector missed in L2 is read from
// and written back to HBM.
// - trilinear_cf_bwd at C % 4 != 0 (until then one thread per (point,
//   channel), 8 scalar atomics each, 200 a point, nothing summed across
//   the ~5 consecutive ray samples that share a cell): the walk above,
//   4.1x faster at the density step's points. Tried and dropped (tools/
//   trilinear_scatter_variants.py rebuilds them): a flush through shared
//   memory, each row as a scalar head, float4 atomics and a scalar tail,
//   all 32 lanes sharing 2 vector and 2 scalar atomic instructions for the
//   8 rows (fewer instructions, as many sectors, and 1.7x the walk's time
//   at the density points); a warp whose 32 points make 30 runs or more
//   (the BEV grid) taking its (point, channel) pairs by a ballot, in the
//   walk's kernel (slower than the walk: a warp keeps its 32 points in
//   flight for all of them) or in a second kernel over a list of such
//   warps (slower still; and a kernel over every pair, leaving at once
//   where the walk took the group, cost ~0.5 ms at the density points in
//   chip_smoke.py's values_ab).
//   The walk loses to the old kernel on the BEV grid's runs of one with a
//   random cotangent, and wins on the step's own, whose zero channels
//   make no atomics.
// - trilinear_bwd_points at C > 1 (until then each point's own lane read
//   its 8 corner rows channel by channel, 200 scalar loads, before the
//   walk): the walk loads a cell's 8 corner rows once, as coalesced rows,
//   when the cell changes; at each point a reduce-scatter over the warp (9
//   shuffles) gives its 8 dots gv . v_k, kept in shared memory, and the
//   point's own lane finishes point_cotangent after the walk. The warp's
//   32 cotangent rows are staged in shared memory before the walk (one
//   load a point in flight, not one at each step). The volume's cotangent
//   stays the walk's.
// The C > 1 point instances' volume cotangent on crowded cells:
// where thousands of rays pass one cell (around a camera), a chain of
// thousands of fp32 atomics on one address drifts ~3x farther from a
// float64 sum than the plain version's sorted sums do (chip_smoke.py
// [head], float64_check). A pre-pass counts the points in each cell; a
// flush from a cell of more than kHotPoints points goes to its voxel's
// fp64 row in a small table, added to the gradient after the kernel
// (hot_add). Tried and slower: the exact rounding error of each atomic
// (from its returned old value, TwoSum) kept in a table, where every warp
// waits for its atomics' returns on the crowded addresses; the whole
// volume in fp64, a 330 MB zero fill and conversion at C = 25. Thresholds
// of 32 and 512 points: tools/trilinear_scatter_variants.py.
// Only the chosen designs are built.
// Measured by chip_smoke.py and tools/trilinear_scatter_variants.py on an
// NVIDIA H100 80GB HBM3, 700.00 W (device ms from torch.profiler, ranges
// over readings; bound: the bytes a call must move over 3.35 TB/s):
// - forward, dense query, C = 25 (walk): 0.817-0.919 ms, bound 0.384;
// - forward, uniform grid, C = 4 (vec4): 0.0103-0.0118, bound 0.0091;
// - forward, the six taps of 1,048,576 samples (plane): 0.0466-0.0523,
//   bound 0.0301;
// - forward, Occ3D sdf plane at row 25 (plane): 0.0562, bound 0.0413
//   with each corner read as a whole 32-byte sector;
// - backward, the six taps (segments): 0.205-0.208, bound 0.0327;
// - backward, uniform grid, C = 4 (float4 atomics): 0.0531-0.0540, bound
//   0.0126;
// - backward, C = 25 (walk), in one call with the old kernel: the density
//   step's 7,372,800 points 1.257-1.275 (old 5.098-5.260), bound 0.296;
//   a 1,048,576-sample chunk 0.240-0.241 (old 0.716-0.739), bound 0.0843;
//   the BEV grid 0.463-0.469 with a random cotangent (old 0.375), 0.271-
//   0.277 with the sdf channel alone (old 0.374-0.376), bound 0.0699;
// - trilinear_bwd_points, C = 25, 4096 x 320 points: 0.6417-0.6423 (old
//   0.6605-0.6662), bound 0.1046; its volume cotangent 2.9e-5 from float64
//   where the fp32 plain version is 9.3e-5;
// - the narrow pair at the flow step's 7,372,800 points, C = 3, border:
//   forward 0.150-0.153 (F.grid_sample 0.223-0.224; the walk 0.881-0.882
//   after the torch clip's 0.62), bound 0.0580; backward, whole calls
//   (fill, segments, fold) 0.549-0.567 (the walk 1.248-1.260; scalar
//   atomics 1.41-1.45), bound 0.0587;
// - the C = 1 point instances, whole calls (fill, segments, fold), in one
//   call with those 7-launch ones (chip_smoke.py --phases head
//   --baseline): the plane one at 4096 x 320 uniform stand-ins
//   0.0675-0.0692 (7-launch: 0.1043),
//   at the importance step's taps 0.0612-0.0684 (0.1269-0.1270), bound
//   0.0177; the rounds' at 4096 x 256 .. 304, 0.0658-0.0696 (0.0814-
//   0.0910) / the step's 272 .. 304, 0.0680-0.0691 (0.0902-0.0952), bound
//   0.0127-0.0144; the six taps 0.286 (7-launch, another call: 0.360), bound
//   0.0697. Of a call, the fp64 fill takes 0.0044 and the fold 0.0083.
// Sums are taken in another order than the plain version's (per run or
// chain, then atomics in any order); the fp32 results agree within the
// tolerances chip_smoke.py states.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarp * kWarps;

// A point's cell: its base corner (the floor of each index) and fractions.
struct Cell {
  int h0, w0, d0;
  float fh, fw, fd;
};

__device__ __forceinline__ Cell cell_of(float h, float w, float d) {
  Cell c;
  c.h0 = __float2int_rd(h);
  c.w0 = __float2int_rd(w);
  c.d0 = __float2int_rd(d);
  c.fh = h - floorf(h);
  c.fw = w - floorf(w);
  c.fd = d - floorf(d);
  return c;
}

__device__ __forceinline__ Cell locate(const float* __restrict__ hwd,
                                       int64_t n) {
  return cell_of(hwd[3 * n], hwd[3 * n + 1], hwd[3 * n + 2]);
}

// Corner k = (ih, iw, id) = (k >> 2, (k >> 1) & 1, k & 1), the reference's
// order. Unsigned compares keep far-away points (saturated indices) out.
__device__ __forceinline__ bool in_volume(const Cell& c, int k, int H, int W,
                                          int D) {
  return static_cast<unsigned>(c.h0) + (k >> 2) < static_cast<unsigned>(H) &&
         static_cast<unsigned>(c.w0) + ((k >> 1) & 1) <
             static_cast<unsigned>(W) &&
         static_cast<unsigned>(c.d0) + (k & 1) < static_cast<unsigned>(D);
}

__device__ __forceinline__ int voxel(const Cell& c, int k, int W, int D) {
  return ((c.h0 + (k >> 2)) * W + c.w0 + ((k >> 1) & 1)) * D + c.d0 + (k & 1);
}

__device__ __forceinline__ float weight(const Cell& c, int k) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  return wh * ww * wd;
}

// d(weight_k)/d(h, w, d) dotted with (gh, gw, gd): channel 0's cotangent
// from grad0 at corner k.
__device__ __forceinline__ float grad0_term(const Cell& c, int k, float gh,
                                            float gw, float gd) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  return ((k & 4) ? 1.f : -1.f) * ww * wd * gh +
         ((k & 2) ? 1.f : -1.f) * wh * wd * gw +
         ((k & 1) ? 1.f : -1.f) * wh * ww * gd;
}

// grad0 += corner k's value g times d(weight_k)/d(h, w, d)
__device__ __forceinline__ void add_grad0(const Cell& c, int k, float g,
                                          float (&g0)[3]) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  g0[0] += ((k & 4) ? 1.f : -1.f) * ww * wd * g;
  g0[1] += ((k & 2) ? 1.f : -1.f) * wh * wd * g;
  g0[2] += ((k & 1) ? 1.f : -1.f) * wh * ww * g;
}

// The cotangent of a point's fractional (h, w, d) indices, as JAX autodiff
// of interp.py:118/:159 gives it (the corner masks are constants): s[k] =
// sum_c gv[c] * v_k[c], the values' cotangent dotted with corner k's row
// (zero outside the volume); c0[k] channel 0 of corner k (zero outside);
// (gh, gw, gd) grad0's cotangent. d vals / d x_j = sum_k s[k] dw_k/dx_j,
// and d grad0_i / d x_j (i != j) = sum_k +-1 * +-1 * (the third weight) *
// c0[k]; d grad0_i / d x_i = 0.
__device__ __forceinline__ void point_cotangent(const Cell& c,
                                                const float (&s)[8],
                                                const float (&c0)[8],
                                                float gh, float gw, float gd,
                                                float (&out)[3]) {
  float ph = 0.f, pw = 0.f, pd = 0.f, mhw = 0.f, mhd = 0.f, mwd = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wh = (k & 4) ? c.fh : 1.f - c.fh;
    const float ww = (k & 2) ? c.fw : 1.f - c.fw;
    const float wd = (k & 1) ? c.fd : 1.f - c.fd;
    const float sh = (k & 4) ? 1.f : -1.f;
    const float sw = (k & 2) ? 1.f : -1.f;
    const float sd = (k & 1) ? 1.f : -1.f;
    ph += sh * ww * wd * s[k];
    pw += sw * wh * wd * s[k];
    pd += sd * wh * ww * s[k];
    mhw += sh * sw * wd * c0[k];
    mhd += sh * ww * sd * c0[k];
    mwd += sw * wh * sd * c0[k];
  }
  out[0] = ph + gw * mhw + gd * mhd;
  out[1] = pw + gh * mhw + gd * mwd;
  out[2] = pd + gh * mhd + gw * mwd;
}

// Writes each lane's C floats to out[C * (tile + lane) + j] through the
// warp's staging buffer (C * 32 floats), as C coalesced stores of 32 floats.
template <int C>
__device__ __forceinline__ void store_rows(float* stage, float* out,
                                           int64_t tile, int64_t num_points,
                                           int lane, const float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) stage[C * lane + j] = v[j];
  __syncwarp();
  const int64_t limit = C * (num_points - tile);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int i = j * kWarp + lane;
    if (i < limit) out[C * tile + i] = stage[i];
  }
}

// A point as the lanes over channels read it from shared memory: its cell
// (key: -1 when no corner is in the volume, else unique per base cell),
// the flat voxel of its base corner, the mask of its in-volume corners and
// its fractions.
struct alignas(16) PointRec {
  int key, base, mask, pad;
  float fh, fw, fd, pad2;
};

__device__ __forceinline__ PointRec point_rec(const Cell& c, bool live,
                                              int H, int W, int D) {
  PointRec r;
  r.mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (live && in_volume(c, k, H, W, D)) r.mask |= 1 << k;
  // with a corner inside, each base index lies in [-1, size - 1]
  r.key = r.mask ? ((c.h0 + 1) * (W + 1) + c.w0 + 1) * (D + 1) + c.d0 + 1
                 : -1;
  r.base = r.mask ? (c.h0 * W + c.w0) * D + c.d0 : 0;
  r.pad = 0;
  r.fh = c.fh;
  r.fw = c.fw;
  r.fd = c.fd;
  r.pad2 = 0.f;
  return r;
}

__device__ __forceinline__ Cell rec_cell(const PointRec& r) {
  Cell c;
  c.h0 = c.w0 = c.d0 = 0;  // only the fractions are read
  c.fh = r.fh;
  c.fw = r.fw;
  c.fd = r.fd;
  return c;
}

// offset of corner k's voxel from the base corner's
__device__ __forceinline__ int corner_offset(int k, int W, int D) {
  return (k >> 2) * W * D + ((k >> 1) & 1) * D + (k & 1);
}

constexpr unsigned kFull = 0xffffffffu;

// x[0..7] summed over the warp's 32 lanes, each sum left in the lanes
// whose lane >> 2 is its corner: a butterfly that halves the values it
// carries at each of the first three steps (4 + 2 + 1 + 1 + 1 shuffles,
// against 8 x 5 for eight separate reductions).
__device__ __forceinline__ float reduce_scatter8(const float (&x)[8],
                                                 int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = (b4 ? x[i + 4] : x[i]) +
           __shfl_xor_sync(kFull, b4 ? x[i] : x[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (b3 ? y[i + 2] : y[i]) +
           __shfl_xor_sync(kFull, b3 ? y[i] : y[i + 2], 8);
  float w = (b2 ? z[1] : z[0]) + __shfl_xor_sync(kFull, b2 ? z[0] : z[1], 4);
  w += __shfl_xor_sync(kFull, w, 2);
  return w + __shfl_xor_sync(kFull, w, 1);
}

// The point instances' volume cotangent on hot voxels. A chain of fp32
// atomics on one address rounds at every link: where thousands of rays
// pass one cell (the cells around a camera), it drifts several times
// farther from the exact sum than a sorted tree sum does. So a pre-pass
// (hot_count_kernel) counts the points in each cell, and a flush from a
// cell of more than kHotPoints points goes to its voxel's row in a small
// table of fp64 sums (keys: the voxel, -1 while free; found by plain loads,
// claimed by one atomicCAS), with fire-and-forget fp64 atomics; the other
// flushes stay fp32 atomics on the gradient, and hot_fold_kernel adds the
// table's rows to them, rounding once. A full table (kHotSlots rows)
// leaves the rest on the fp32 chain.
constexpr int kHotSlots = 1 << 15;  // ops/interp.py: HOT_SLOTS
constexpr int kHotProbes = 32;
constexpr int kHotPoints = 128;

struct Hot {
  const int* counts;  // points in each cell, by base voxel (nvox)
  int* keys;
  double* sums;       // kHotSlots x C
  int nvox;
};

__device__ __forceinline__ bool hot_cell(const Hot& hot, int base) {
  return static_cast<unsigned>(base) < static_cast<unsigned>(hot.nvox) &&
         __ldg(hot.counts + base) > kHotPoints;
}

// grad[vox * C + ch] += x: if `is_hot`, into the voxel's fp64 row of the
// table, else (or where kHotProbes slots hold other voxels) an fp32
// atomic on grad. Keys are read by plain loads: a key, once set, never
// changes, so a stale read of -1 only leads to an atomicCAS that returns
// it.
__device__ __forceinline__ void hot_add(const Hot& hot, bool is_hot,
                                        float* grad, int vox, int C, int ch,
                                        float x) {
  if (is_hot) {
    unsigned h = (static_cast<unsigned>(vox) * 2654435761u) & (kHotSlots - 1);
    for (int probe = 0; probe < kHotProbes; ++probe) {
      int key = hot.keys[h];
      if (key == -1) key = atomicCAS(hot.keys + h, -1, vox);
      if (key == -1 || key == vox) {
        atomicAdd(hot.sums + static_cast<int64_t>(h) * C + ch,
                  static_cast<double>(x));
        return;
      }
      h = (h + 1) & (kHotSlots - 1);
    }
  }
  atomicAdd(grad + static_cast<int64_t>(vox) * C + ch, x);
}

// counts[cell] += its points: one atomic a run of one cell in a warp
__global__ void __launch_bounds__(kThreads)
    hot_count_kernel(const float* __restrict__ hwd, int64_t num_points,
                     int H, int W, int D, int* __restrict__ counts) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  int base = -1;
  if (n < num_points) {
    const Cell c = locate(hwd, n);
    if (static_cast<unsigned>(c.h0) < static_cast<unsigned>(H) &&
        static_cast<unsigned>(c.w0) < static_cast<unsigned>(W) &&
        static_cast<unsigned>(c.d0) < static_cast<unsigned>(D))
      base = (c.h0 * W + c.w0) * D + c.d0;
  }
  const int prev = __shfl_up_sync(kFull, base, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || base != prev);
  if (base >= 0 && ((heads >> lane) & 1)) {
    const unsigned later = heads & ~((2u << lane) - 1u);
    const int end = later ? __ffs(later) - 1 : kWarp;
    atomicAdd(counts + base, end - lane);
  }
}

// grad (H, W, D, C) += the table's rows, one thread a (slot, channel)
__global__ void __launch_bounds__(kThreads)
    hot_fold_kernel(const int* __restrict__ keys,
                    const double* __restrict__ sums, float* __restrict__ grad,
                    int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(kHotSlots) * C) return;
  const int vox = keys[i / C];
  if (vox >= 0) {
    float* g = grad + static_cast<int64_t>(vox) * C + i % C;
    *g = static_cast<float>(static_cast<double>(*g) + sums[i]);
  }
}

// ---------------------------------------------------------------- forward

// C = 1: vol is the contiguous (H, W, D) plane. One lane per point.
__global__ void __launch_bounds__(kThreads)
    trilinear_fwd_plane_kernel(const float* __restrict__ vol,
                               const float* __restrict__ hwd,
                               float* __restrict__ vals,
                               float* __restrict__ grad0, int64_t num_points,
                               int H, int W, int D) {
  __shared__ float stage[kWarps][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  float g0[3] = {0.f, 0.f, 0.f};
  if (n < num_points) {
    const Cell c = locate(hwd, n);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v =
          in_volume(c, k, H, W, D) ? __ldg(vol + voxel(c, k, W, D)) : 0.f;
      acc += weight(c, k) * v;
      add_grad0(c, k, v, g0);
    }
    vals[n] = acc;
  }
  store_rows<3>(stage[warp], grad0, tile, num_points, lane, g0);
}

// C > 1: vol is the contiguous (H, W, D, C). grad0 from the point's own
// lane (channel 0 of its corners), vals from lanes over channels walking
// the points in order and keeping the 8 corner rows of the current cell in
// registers: a point in the same cell as the one before it loads nothing.
__global__ void __launch_bounds__(kThreads)
    trilinear_fwd_rows_kernel(const float* __restrict__ vol,
                              const float* __restrict__ hwd,
                              float* __restrict__ vals,
                              float* __restrict__ grad0, int64_t num_points,
                              int C, int H, int W, int D) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float stage[kWarps][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  if (live) c = locate(hwd, n);
  const PointRec mine = point_rec(c, live, H, W, D);
  recs[warp][lane] = mine;
  {
    float g0[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      add_grad0(c, k,
                (mine.mask >> k) & 1
                    ? __ldg(vol + static_cast<int64_t>(
                                      mine.base + corner_offset(k, W, D)) *
                                      C)
                    : 0.f,
                g0);
    store_rows<3>(stage[warp], grad0, tile, num_points, lane, g0);
  }
  __syncwarp();

  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    float rowv[8];
    int key = -2;  // no cell loaded yet
    for (int p = 0; p < count; ++p) {  // warp-uniform
      const PointRec r = recs[warp][p];
      if (r.key != key) {
        key = r.key;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          rowv[k] = ((r.mask >> k) & 1) && ch < C
                        ? __ldg(vol +
                                static_cast<int64_t>(r.base +
                                                     corner_offset(k, W, D)) *
                                    C +
                                ch)
                        : 0.f;
      }
      const Cell rc = rec_cell(r);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += weight(rc, k) * rowv[k];
      if (ch < C) vals[(tile + p) * C + ch] = acc;
    }
  }
}

// --------------------------------------------------------------- backward

// Per-warp tables of the plane backward: for 32 consecutive points and
// their 8 corners, the corner's voxel (-1 outside the volume or past the
// last point), its contribution (weight * gv + the grad0 term), and the
// slot of the same voxel in the next point (-1: the chain ends).
struct ChainTables {
  int h0[kWarp], w0[kWarp], d0[kWarp];
  int vox[8][kWarp];
  float con[8][kWarp];
  signed char next[8][kWarp];
};

// C = 1: grad is the (H, W, D) plane. One lane per point. A voxel's
// contributions from consecutive points form a chain (each point notes the
// slot of the voxel in the next point, if the next point's cell touches
// it); the chain's first lane, whose previous lane does not touch the
// voxel, sums it and makes the voxel's one atomic. Unlike a run of one
// cell, a chain goes on across a step into a neighbouring cell.
//
// kPoints: also the points' cotangent (N, 3) into gpts, each point's own
// lane reading its 8 corners of vol, the (H, W, D) plane, and the chains'
// sums into the fp64 plane acc. Only the point-free instance is built: the
// point instance launches plane_points_kernel<true> (its chains are the
// with-grad design that tools/trilinear_scatter_variants.py rebuilds).
template <bool kPoints>
__global__ void __launch_bounds__(kThreads)
    trilinear_bwd_plane_kernel(const float* __restrict__ hwd,
                               const float* __restrict__ gv,
                               const float* __restrict__ gg,
                               float* __restrict__ grad, int64_t num_points,
                               int H, int W, int D,
                               const float* __restrict__ vol,
                               float* __restrict__ gpts,
                               double* __restrict__ acc) {
  __shared__ ChainTables tables[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  ChainTables& t = tables[warp];
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = INT32_MIN;  // a base no valid voxel is next to
  c.fh = c.fw = c.fd = 0.f;
  float gh = 0.f, gw = 0.f, gd = 0.f, g = 0.f;
  if (live) {
    c = locate(hwd, n);
    if (gg != nullptr) {
      gh = gg[3 * n];
      gw = gg[3 * n + 1];
      gd = gg[3 * n + 2];
    }
    if (gv != nullptr) g = gv[n];
    if constexpr (kPoints) {
      float v[8], sv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = in_volume(c, k, H, W, D) ? __ldg(vol + voxel(c, k, W, D))
                                        : 0.f;
        sv[k] = g * v[k];
      }
      float out[3];
      point_cotangent(c, sv, v, gh, gw, gd, out);
      gpts[3 * n] = out[0];
      gpts[3 * n + 1] = out[1];
      gpts[3 * n + 2] = out[2];
    }
  }
  t.h0[lane] = c.h0;
  t.w0[lane] = c.w0;
  t.d0[lane] = c.d0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t.vox[k][lane] = live && in_volume(c, k, H, W, D) ? voxel(c, k, W, D)
                                                      : -1;
    t.con[k][lane] = weight(c, k) * g + grad0_term(c, k, gh, gw, gd);
  }
  __syncwarp();

  // a point at base b touches voxel v as its corner v - b when every axis
  // of v - b is 0 or 1
  unsigned heads = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int nxt = -1;
    if (t.vox[k][lane] >= 0) {
      const unsigned vh = c.h0 + (k >> 2), vw = c.w0 + ((k >> 1) & 1),
                     vd = c.d0 + (k & 1);
      if (lane + 1 < kWarp) {
        const unsigned dh = vh - t.h0[lane + 1], dw = vw - t.w0[lane + 1],
                       dd = vd - t.d0[lane + 1];
        if (dh <= 1u && dw <= 1u && dd <= 1u)
          nxt = static_cast<int>(dh * 4 + dw * 2 + dd);
      }
      bool head = true;
      if (lane > 0) {
        const unsigned dh = vh - t.h0[lane - 1], dw = vw - t.w0[lane - 1],
                       dd = vd - t.d0[lane - 1];
        head = !(dh <= 1u && dw <= 1u && dd <= 1u);
      }
      if (head) heads |= 1u << k;
    }
    t.next[k][lane] = static_cast<signed char>(nxt);
  }
  __syncwarp();
  while (heads) {
    const int k = __ffs(heads) - 1;
    heads &= heads - 1;
    float sum = 0.f;
    int q = lane, kk = k;
    do {
      sum += t.con[kk][q];
      kk = t.next[kk][q];
      ++q;
    } while (kk >= 0);
    if constexpr (kPoints)
      atomicAdd(acc + t.vox[k][lane], static_cast<double>(sum));
    else
      atomicAdd(grad + t.vox[k][lane], sum);
  }
}

// The corner bit along which two cells one unit step apart differ (4: h,
// 2: w, 1: d), or 0; up: the new cell is the old one plus that step. Keys
// that differ by one step of an axis may also come from that axis's index
// wrapping into the next coarser axis; then the corners that would carry
// over lie at index -1 or size along that axis, outside the volume in both
// cells, and carrying them moves zeros or unflushed sums.
__device__ __forceinline__ int unit_step(int from, int to, int W, int D,
                                         bool& up) {
  up = to > from;
  if (from < 0 || to < 0) return 0;
  const int d = up ? to - from : from - to;
  return d == 1 ? 1 : d == D + 1 ? 2 : d == (W + 1) * (D + 1) ? 4 : 0;
}

// The 4 corners two cells one step apart along kBit share: up, new corner
// k = old corner k | kBit; down, new corner k | kBit = old corner k (k
// without kBit).
template <int kBit>
__device__ __forceinline__ void carry(float (&v)[8], bool up) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (!(k & kBit)) {
      if (up)
        v[k] = v[k | kBit];
      else
        v[k | kBit] = v[k];
    }
}

__device__ __forceinline__ void carry(float (&v)[8], int bit, bool up) {
  if (bit == 1)
    carry<1>(v, up);
  else if (bit == 2)
    carry<2>(v, up);
  else if (bit == 4)
    carry<4>(v, up);
}

// corner k of the new cell is one the old cell did not have (with !up:
// corner k of the old cell is one the new cell does not have)
__device__ __forceinline__ bool fresh(int k, int bit, bool up) {
  return bit == 0 || ((k & bit) != 0) == up;
}

// C > 1: grad is (H, W, D, C). Lanes over channels walk the points in
// order and sum each run of points in one cell into 8 registers (one per
// corner); when the cell changes, the corner rows the next cell does not
// share take one atomic per lane each (all 8 unless it is a unit step
// away), and the shared ones carry their sums over.
//
// kPoints: also the points' cotangent (N, 3) into gpts. The walk's lanes
// load the current cell's 8 corner rows of vol (H, W, D, C) when the cell
// changes (8 coalesced row loads); at each point they multiply them by
// their channel of gv, and a reduce-scatter over the warp gives the
// point's 8 dots gv . v_k, which go to shared memory. After the walk each
// point's own lane reads its dots and channel 0 of its corners and
// finishes point_cotangent. The cotangent rows of the warp's 32 points are
// staged in dynamic shared memory (32 x 32 floats a warp) by one load per
// point before the walk, not one at each step of it, and a hot cell's
// rows are summed in fp64 (hot_add).
template <bool kPoints>
__global__ void __launch_bounds__(kThreads)
    trilinear_bwd_rows_kernel(const float* __restrict__ hwd,
                              const float* __restrict__ gv,
                              const float* __restrict__ gg,
                              float* __restrict__ grad, int64_t num_points,
                              int C, int H, int W, int D,
                              const float* __restrict__ vol,
                              float* __restrict__ gpts, Hot hot) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float4 exts[kWarps][kWarp][2];  // channel 0's grad0 terms
  extern __shared__ float staged[];  // kPoints: [kWarps][kWarp][kWarp]
  // kPoints: each point's dots gv . v_k with its 8 corner rows
  __shared__ float dots[kPoints ? kWarps : 1][kWarp][8];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  float gh = 0.f, gw = 0.f, gd = 0.f;
  if (live) {
    c = locate(hwd, n);
    if (gg != nullptr) {
      gh = gg[3 * n];
      gw = gg[3 * n + 1];
      gd = gg[3 * n + 2];
    }
  }
  recs[warp][lane] = point_rec(c, live, H, W, D);
  if constexpr (kPoints) {
#pragma unroll
    for (int k = 0; k < 8; ++k) dots[warp][lane][k] = 0.f;
  }
  exts[warp][lane][0] =
      make_float4(grad0_term(c, 0, gh, gw, gd), grad0_term(c, 1, gh, gw, gd),
                  grad0_term(c, 2, gh, gw, gd), grad0_term(c, 3, gh, gw, gd));
  exts[warp][lane][1] =
      make_float4(grad0_term(c, 4, gh, gw, gd), grad0_term(c, 5, gh, gw, gd),
                  grad0_term(c, 6, gh, gw, gd), grad0_term(c, 7, gh, gw, gd));
  __syncwarp();

  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    // this lane's channel takes updates: every channel from grad_vals,
    // channel 0 also from grad_grad0
    const bool active = ch < C && (gv != nullptr || ch == 0);
    float* stage = staged + warp * kWarp * kWarp;  // kPoints: [p][lane]
    if constexpr (kPoints) {
      for (int p = 0; p < count; ++p)
        stage[p * kWarp + lane] =
            gv != nullptr && ch < C ? __ldg(gv + (tile + p) * C + ch) : 0.f;
      __syncwarp();
    }
    float acc[8], rowv[8];
    PointRec cur;
    cur.key = -1;
    cur.base = cur.mask = 0;
    bool cur_hot = false;
    for (int p = 0; p <= count; ++p) {  // warp-uniform; p == count flushes
      const PointRec r = recs[warp][p < count ? p : 0];
      const int key = p < count ? r.key : -2;
      if (key != cur.key) {
        bool up;
        const int bit = unit_step(cur.key, key, W, D, up);
        if (cur.key != -1 && active) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (((cur.mask >> k) & 1) && fresh(k, bit, !up)) {
              if constexpr (kPoints)
                hot_add(hot, cur_hot, grad, cur.base + corner_offset(k, W, D),
                        C, ch, acc[k]);
              else
                atomicAdd(grad + static_cast<int64_t>(
                                     cur.base + corner_offset(k, W, D)) *
                                     C +
                              ch,
                          acc[k]);
            }
        }
        carry(acc, bit, up);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (fresh(k, bit, up)) acc[k] = 0.f;
        cur = r;
        cur.key = key;
        if constexpr (kPoints) {
          cur_hot = key >= 0 && hot_cell(hot, r.base);
          if (gv != nullptr && key >= 0) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              rowv[k] = ((r.mask >> k) & 1) && ch < C
                            ? __ldg(vol +
                                    static_cast<int64_t>(
                                        r.base + corner_offset(k, W, D)) *
                                        C +
                                    ch)
                            : 0.f;
          }
        }
      }
      if (p == count || key == -1) continue;
      float g;
      if constexpr (kPoints)
        g = stage[p * kWarp + lane];
      else
        g = gv != nullptr && ch < C ? __ldg(gv + (tile + p) * C + ch) : 0.f;
      const Cell rc = rec_cell(r);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += weight(rc, k) * g;
      if (ch == 0) {
        const float4 e0 = exts[warp][p][0], e1 = exts[warp][p][1];
        acc[0] += e0.x;
        acc[1] += e0.y;
        acc[2] += e0.z;
        acc[3] += e0.w;
        acc[4] += e1.x;
        acc[5] += e1.y;
        acc[6] += e1.z;
        acc[7] += e1.w;
      }
      if constexpr (kPoints) {
        if (gv != nullptr) {
          float x[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) x[k] = g * rowv[k];
          const float s = reduce_scatter8(x, lane);
          if ((lane & 3) == 0) dots[warp][p][lane >> 2] += s;
        }
      }
    }
  }
  if constexpr (kPoints) {
    __syncwarp();
    if (live) {
      const PointRec mine = recs[warp][lane];
      float s[8], c0[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] = dots[warp][lane][k];
        c0[k] = gg != nullptr && ((mine.mask >> k) & 1)
                    ? __ldg(vol + static_cast<int64_t>(
                                      mine.base + corner_offset(k, W, D)) *
                                      C)
                    : 0.f;
      }
      float out[3];
      point_cotangent(c, s, c0, gh, gw, gd, out);
      gpts[3 * n] = out[0];
      gpts[3 * n + 1] = out[1];
      gpts[3 * n + 2] = out[2];
    }
  }
}

// ------------------------------------------------------------ values only

constexpr int kTileMax = 128;       // points per block, pairs forward
constexpr int kStageFloats = 8192;  // its staged (points, C) values, 32 KB
constexpr int kSlotBits = 10;
constexpr int kSlots = 1 << kSlotBits;  // plane backward's table
constexpr int kProbes = 8;          // slots tried before a global atomic
constexpr int kEmpty = -1;
constexpr int kSegTiles = 4;  // 256-point tiles per block

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// C = 1: vol is the (H, W, D) plane, one value every `row` floats. One
// thread per point; its 8 corner loads are issued before the sum.
__global__ void __launch_bounds__(kThreads)
    values_fwd_plane_kernel(const float* __restrict__ vol,
                            const float* __restrict__ hwd,
                            float* __restrict__ vals, int64_t num_points,
                            int H, int W, int D, int64_t row) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= num_points) return;
  const Cell c = locate(hwd, n);
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = in_volume(c, k, H, W, D)
               ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) * row)
               : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += weight(c, k) * v[k];
  vals[n] = acc;
}

// C = 4 with 16-byte rows (`row4` float4s apart): one thread per point, a
// float4 load per corner row and one float4 store.
__global__ void __launch_bounds__(kThreads)
    values_fwd_vec4_kernel(const float4* __restrict__ vol,
                           const float* __restrict__ hwd,
                           float4* __restrict__ vals, int64_t num_points,
                           int H, int W, int D, int64_t row4) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= num_points) return;
  const Cell c = locate(hwd, n);
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = in_volume(c, k, H, W, D)
               ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) * row4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = weight(c, k);
    acc.x += w * v[k].x;
    acc.y += w * v[k].y;
    acc.z += w * v[k].z;
    acc.w += w * v[k].w;
  }
  vals[n] = acc;
}

// C > 1: vol is (H, W, D, C) with `row` >= C floats between voxels. A block
// takes `tile` consecutive points (a multiple of 4). Each point's base
// voxel, corner mask and 8 weights are computed once, by its own thread,
// into shared memory; then the threads go over the tile's (point, channel)
// pairs, each pair's 8 corner loads independent of every other pair's, and
// stage the tile's (tile, C) values, which lie contiguous in vals, for
// float4 stores (`vec_store`: vals is 16-byte aligned). Dynamic shared
// memory: tile * C floats of values, then tile * 8 weights, tile bases and
// tile masks.
__global__ void __launch_bounds__(kThreads)
    values_fwd_rows_kernel(const float* __restrict__ vol,
                           const float* __restrict__ hwd,
                           float* __restrict__ vals, int64_t num_points,
                           int C, int H, int W, int D, int64_t row, int tile,
                           bool vec_store) {
  extern __shared__ float4 values_smem[];
  float* stage = reinterpret_cast<float*>(values_smem);
  float* wts = stage + tile * C;
  int* base = reinterpret_cast<int*>(wts + 8 * tile);
  int* mask = base + tile;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  const int count = static_cast<int>(
      num_points - first < tile ? num_points - first : tile);
  for (int p = threadIdx.x; p < tile; p += kThreads) {
    int m = 0, b = 0;
    if (p < count) {
      const Cell c = locate(hwd, first + p);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (in_volume(c, k, H, W, D)) m |= 1 << k;
        wts[8 * p + k] = weight(c, k);
      }
      if (m) b = (c.h0 * W + c.w0) * D + c.d0;
    }
    base[p] = b;
    mask[p] = m;
  }
  __syncthreads();
  const int total = count * C;
  const int dp = kThreads / C, dc = kThreads % C;
  int p = threadIdx.x / C, ch = threadIdx.x % C;
  for (int i = threadIdx.x; i < total; i += kThreads) {  // i == p * C + ch
    const int m = mask[p];
    const int64_t b = base[p];
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (m >> k) & 1
                 ? __ldg(vol + (b + corner_offset(k, W, D)) * row + ch)
                 : 0.f;
    const float* w = wts + 8 * p;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += w[k] * v[k];
    stage[i] = acc;
    p += dp;
    ch += dc;
    if (ch >= C) {
      ch -= C;
      ++p;
    }
  }
  __syncthreads();
  float* out = vals + first * C;
  int done = 0;
  if (vec_store) {
    done = total & ~3;
    for (int j = threadIdx.x; j < (total >> 2); j += kThreads)
      reinterpret_cast<float4*>(out)[j] = values_smem[j];
  }
  for (int j = done + threadIdx.x; j < total; j += kThreads) out[j] = stage[j];
}

// 3 < C <= 32 (and C = 2, 3 in a build without the narrow instances): vol
// is (H, W, D, C) with `row` >= C floats between voxels. A warp takes 32
// consecutive points; each point's own lane computes its
// cell record and its 8 weights into shared memory, once; then the lanes
// over channels walk the points in order, keeping the 8 corner rows of the
// current cell in registers and loading them again only when the cell
// changes, and store each point's row of values.
__global__ void __launch_bounds__(kThreads)
    values_fwd_walk_kernel(const float* __restrict__ vol,
                           const float* __restrict__ hwd,
                           float* __restrict__ vals, int64_t num_points,
                           int C, int H, int W, int D, int64_t row) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float4 wts[kWarps][kWarp][2];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  if (live) c = locate(hwd, n);
  recs[warp][lane] = point_rec(c, live, H, W, D);
  wts[warp][lane][0] = make_float4(weight(c, 0), weight(c, 1), weight(c, 2),
                                   weight(c, 3));
  wts[warp][lane][1] = make_float4(weight(c, 4), weight(c, 5), weight(c, 6),
                                   weight(c, 7));
  __syncwarp();
  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  float rowv[8];
  int key = -2;  // no cell loaded yet
  for (int p = 0; p < count; ++p) {  // warp-uniform
    const PointRec r = recs[warp][p];
    if (r.key != key) {
      key = r.key;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        rowv[k] = ((r.mask >> k) & 1) && lane < C
                      ? __ldg(vol +
                              static_cast<int64_t>(r.base +
                                                   corner_offset(k, W, D)) *
                                  row +
                              lane)
                      : 0.f;
    }
    const float4 w0 = wts[warp][p][0], w1 = wts[warp][p][1];
    float acc = 0.f;
    acc += w0.x * rowv[0];
    acc += w0.y * rowv[1];
    acc += w0.z * rowv[2];
    acc += w0.w * rowv[3];
    acc += w1.x * rowv[4];
    acc += w1.y * rowv[5];
    acc += w1.z * rowv[6];
    acc += w1.w * rowv[7];
    if (lane < C) vals[(tile + p) * C + lane] = acc;
  }
}

// x into voxel vox's slot of the block's table (open addressing, linear
// probing); where kProbes slots hold other voxels, straight into out (the
// gradient plane, or the point instances' fp64 plane).
template <typename T>
__device__ __forceinline__ void table_add(int* keys, float* sums, int vox,
                                          float x, T* out) {
  unsigned h = (static_cast<unsigned>(vox) * 2654435761u) >> (32 - kSlotBits);
  for (int probe = 0; probe < kProbes; ++probe) {
    int key = *reinterpret_cast<volatile int*>(keys + h);
    if (key == kEmpty) key = atomicCAS(keys + h, kEmpty, vox);
    if (key == kEmpty || key == vox) {
      atomicAdd(sums + h, x);
      return;
    }
    h = (h + 1) & (kSlots - 1);
  }
  atomicAdd(out + vox, static_cast<T>(x));
}

// The C = 1 backward by segments. A block takes `tiles` tiles of 256
// consecutive points, one point per thread. The lanes of a warp whose points
// lie in one cell, consecutive lanes, form a segment; a segmented scan (5
// shuffle steps for each corner) sums each segment's 8 contributions into
// its last lane, which puts the in-volume ones into the block's table. The
// table is flushed into out with one global atomic per slot after every
// kSegTiles tiles. On ray-major points (the six compact taps of a sample,
// then the next sample; the importance samples gathered around a surface) a
// warp's 32 points mostly span one or two cells.
//
// kPoints: also the points' cotangent (N, 3) into gpts, from the 8 corners
// of vol (the plane, one value every `row` floats) that each lane loads
// (lanes of one cell load the same words, one request), stored through the
// warp's staging buffer; out is the fp64 plane. kGrad0: the with-grad
// instance: a point's contribution adds the grad0 term of gg (N, 3), and
// its cotangent the grad0 part.
template <bool kPoints, bool kGrad0, typename T>
__device__ __forceinline__ void plane_seg(const float* __restrict__ hwd,
                                          const float* __restrict__ gv,
                                          const float* __restrict__ gg,
                                          T* __restrict__ out,
                                          int64_t num_points, int H, int W,
                                          int D, const float* __restrict__ vol,
                                          int64_t row,
                                          float* __restrict__ gpts,
                                          int tiles) {
  __shared__ int keys[kSlots];
  __shared__ float sums[kSlots];
  __shared__ float stage[kPoints ? kWarps : 1][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tiles;
  for (int t0 = 0; t0 < tiles; t0 += kSegTiles) {
    for (int i = threadIdx.x; i < kSlots; i += kThreads) {
      keys[i] = kEmpty;
      sums[i] = 0.f;
    }
    __syncthreads();
    const int t1 = t0 + kSegTiles < tiles ? t0 + kSegTiles : tiles;
    for (int t = t0; t < t1; ++t) {
      const int64_t tile = (first + t) * kThreads + warp * kWarp;
      if (tile >= num_points) break;  // the whole warp
      const int64_t n = tile + lane;
      const bool live = n < num_points;
      // points past the end: a cell with no corner in the volume
      Cell c;
      c.h0 = c.w0 = c.d0 = -2;
      c.fh = c.fw = c.fd = 0.f;
      float g = 0.f, gh = 0.f, gw = 0.f, gd = 0.f;
      if (live) {
        c = locate(hwd, n);
        if (gv != nullptr) g = gv[n];
        if constexpr (kGrad0)
          if (gg != nullptr) {
            gh = gg[3 * n];
            gw = gg[3 * n + 1];
            gd = gg[3 * n + 2];
          }
      }
      const int ph = __shfl_up_sync(kFull, c.h0, 1);
      const int pw = __shfl_up_sync(kFull, c.w0, 1);
      const int pd = __shfl_up_sync(kFull, c.d0, 1);
      const unsigned heads = __ballot_sync(
          kFull, lane == 0 || c.h0 != ph || c.w0 != pw || c.d0 != pd);
      const int start = 31 - __clz(heads & upto);
      const unsigned later = heads & ~upto;
      const bool last = later ? __ffs(later) - 2 == lane : lane == kWarp - 1;
      if constexpr (kPoints) {
        float v[8], sv[8], cot[3];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[k] = in_volume(c, k, H, W, D)
                     ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) *
                                       row)
                     : 0.f;
          sv[k] = g * v[k];
        }
        point_cotangent(c, sv, v, gh, gw, gd, cot);
        store_rows<3>(stage[warp], gpts, tile, num_points, lane, cot);
        __syncwarp();  // the staging buffer is written again next tile
      }
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[k] = weight(c, k) * g;
        if constexpr (kGrad0) x[k] += grad0_term(c, k, gh, gw, gd);
      }
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float y = __shfl_up_sync(kFull, x[k], d);
          if (lane - d >= start) x[k] += y;
        }
      }
      if (last) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (in_volume(c, k, H, W, D))
            table_add(keys, sums, voxel(c, k, W, D), x[k], out);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSlots; i += kThreads)
      if (keys[i] != kEmpty) atomicAdd(out + keys[i], static_cast<T>(sums[i]));
    __syncthreads();  // the table is cleared for the next tiles
  }
}

// C = 1, point-free: grad is the (H, W, D) plane; kSegTiles tiles a block.
__global__ void __launch_bounds__(kThreads)
    values_bwd_plane_seg_kernel(const float* __restrict__ hwd,
                                const float* __restrict__ gv,
                                float* __restrict__ grad, int64_t num_points,
                                int H, int W, int D) {
  plane_seg<false, false>(hwd, gv, nullptr, grad, num_points, H, W, D,
                          nullptr, 0, nullptr, kSegTiles);
}

// The C = 1 point instances (trilinear_bwd's with grad0, trilinear_cf_bwd's
// values only, at row stride `row`): the volume's cotangent summed into acc,
// the zeroed fp64 (H, W, D) plane, which plane_fold_kernel rounds into the
// fp32 gradient once. A crowded cell's sums (thousands of rays through one
// cell around a camera) then take no chain of fp32 roundings; the plane,
// 13.2 MB at 257 x 257 x 25, stays in L2.
__global__ void __launch_bounds__(kThreads)
    trilinear_bwd_plane_points_kernel(const float* __restrict__ hwd,
                                      const float* __restrict__ gv,
                                      const float* __restrict__ gg,
                                      double* __restrict__ acc,
                                      int64_t num_points, int H, int W, int D,
                                      const float* __restrict__ vol,
                                      float* __restrict__ gpts, int tiles) {
  plane_seg<true, true>(hwd, gv, gg, acc, num_points, H, W, D, vol, 1, gpts,
                        tiles);
}

__global__ void __launch_bounds__(kThreads)
    values_bwd_plane_points_kernel(const float* __restrict__ hwd,
                                   const float* __restrict__ gv,
                                   double* __restrict__ acc,
                                   int64_t num_points, int H, int W, int D,
                                   const float* __restrict__ vol, int64_t row,
                                   float* __restrict__ gpts, int tiles) {
  plane_seg<true, false>(hwd, gv, nullptr, acc, num_points, H, W, D, vol,
                         row, gpts, tiles);
}

// grad[i] = acc[i] rounded to fp32, every element
__global__ void __launch_bounds__(kThreads)
    trilinear_plane_fold_kernel(const double* __restrict__ acc,
                                float* __restrict__ grad, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < count) grad[i] = static_cast<float>(acc[i]);
}

// C a multiple of 4, gv and grad 16-byte aligned: grad is (H, W, D, C).
// One thread per (point, group of 4 channels), one float4 atomic per
// in-volume corner row, 8 per point at C = 4 (compute capability 9.x).
__global__ void __launch_bounds__(kThreads)
    values_bwd_rows_kernel(const float* __restrict__ hwd,
                           const float* __restrict__ gv,
                           float* __restrict__ grad, int64_t num_points,
                           int C, int H, int W, int D) {
  const int groups = C / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_points * groups) return;
  const int64_t n = i / groups;
  const int j = static_cast<int>(i - n * groups);
  const Cell c = locate(hwd, n);
  const float4 g = __ldg(reinterpret_cast<const float4*>(gv + n * C) + j);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (in_volume(c, k, H, W, D)) {
      const float w = weight(c, k);
      atomicAdd(reinterpret_cast<float4*>(
                    grad + static_cast<int64_t>(voxel(c, k, W, D)) * C) +
                    j,
                make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
    }
}

// C > 3 (any C not taken by values_bwd_rows_kernel): grad is (H, W, D, C).
// A warp takes 32 consecutive points; each point's own lane computes its
// cell record and 8 weights into shared memory, once. Then the lanes over
// channels (32 at a time) walk the points in order and sum each run of
// points in one cell into 8 registers, one per corner; when the cell
// changes, the corner rows the next cell does not share take one atomic
// per lane (all 8 unless it is a unit step away; none for a sum of exact
// zeros, so that a cotangent with one live channel, as the uniform sdf
// grid's, makes one atomic a row) and the shared ones carry their sums
// over.
//
// kPoints (always walks): also the points' cotangent (N, 3) into gpts.
// The lanes load the current cell's 8 corner rows of vol (H, W, D, C with
// `row` >= C floats between voxels) when the cell changes, and at each
// point a reduce-scatter over the warp gives its 8 dots gv . v_k, kept in
// shared memory; after the walk each point's own lane finishes
// point_cotangent. A hot cell's rows are summed in fp64 (hot_add).
template <bool kPoints>
__global__ void __launch_bounds__(kThreads)
    values_bwd_walk_kernel(const float* __restrict__ hwd,
                           const float* __restrict__ gv,
                           float* __restrict__ grad, int64_t num_points,
                           int C, int H, int W, int D,
                           const float* __restrict__ vol, int64_t row,
                           float* __restrict__ gpts, Hot hot) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float4 wts[kWarps][kWarp][2];
  __shared__ float dots[kPoints ? kWarps : 1][kWarp][8];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  if (live) c = locate(hwd, n);
  recs[warp][lane] = point_rec(c, live, H, W, D);
  wts[warp][lane][0] = make_float4(weight(c, 0), weight(c, 1), weight(c, 2),
                                   weight(c, 3));
  wts[warp][lane][1] = make_float4(weight(c, 4), weight(c, 5), weight(c, 6),
                                   weight(c, 7));
  if constexpr (kPoints) {
#pragma unroll
    for (int k = 0; k < 8; ++k) dots[warp][lane][k] = 0.f;
  }
  __syncwarp();

  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    float acc[8], rowv[8];
    PointRec cur;
    cur.key = -1;
    cur.base = cur.mask = 0;
    bool cur_hot = false;
    for (int p = 0; p <= count; ++p) {  // warp-uniform; p == count flushes
      const PointRec r = recs[warp][p < count ? p : 0];
      const int key = p < count ? r.key : -2;
      if (key != cur.key) {
        bool up;
        const int bit = unit_step(cur.key, key, W, D, up);
        if (cur.key != -1 && ch < C) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (((cur.mask >> k) & 1) && fresh(k, bit, !up) &&
                acc[k] != 0.f) {
              if constexpr (kPoints)
                hot_add(hot, cur_hot, grad, cur.base + corner_offset(k, W, D),
                        C, ch, acc[k]);
              else
                atomicAdd(grad + static_cast<int64_t>(
                                     cur.base + corner_offset(k, W, D)) *
                                     C +
                              ch,
                          acc[k]);
            }
        }
        carry(acc, bit, up);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (fresh(k, bit, up)) acc[k] = 0.f;
        cur = r;
        cur.key = key;
        if constexpr (kPoints) {
          cur_hot = key >= 0 && hot_cell(hot, r.base);
          if (key >= 0) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              rowv[k] = ((r.mask >> k) & 1) && ch < C
                            ? __ldg(vol +
                                    static_cast<int64_t>(
                                        r.base + corner_offset(k, W, D)) *
                                        row +
                                    ch)
                            : 0.f;
          }
        }
      }
      if (p == count || key == -1) continue;
      const float g = ch < C ? __ldg(gv + (tile + p) * C + ch) : 0.f;
      const float4 w0 = wts[warp][p][0], w1 = wts[warp][p][1];
      acc[0] += w0.x * g;
      acc[1] += w0.y * g;
      acc[2] += w0.z * g;
      acc[3] += w0.w * g;
      acc[4] += w1.x * g;
      acc[5] += w1.y * g;
      acc[6] += w1.z * g;
      acc[7] += w1.w * g;
      if constexpr (kPoints) {
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = g * rowv[k];
        const float s = reduce_scatter8(x, lane);
        if ((lane & 3) == 0) dots[warp][p][lane >> 2] += s;
      }
    }
  }
  if constexpr (kPoints) {
    __syncwarp();
    if (live) {
      float s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = dots[warp][lane][k];
      float out[3];
      point_cotangent(c, s, s, 0.f, 0.f, 0.f, out);
      gpts[3 * n] = out[0];
      gpts[3 * n + 1] = out[1];
      gpts[3 * n + 2] = out[2];
    }
  }
}

// ------------------------------------------------ values only, narrow rows

// The narrow instances: C <= kNarrowMax (the flow head's lookup, C = 3),
// either padding. One thread per point, as the plane kernels.
constexpr int kNarrowMax = 3;

// A point's cell; with kBorder its indices first clipped to [0, size - 1]
// (interp.py:131-134).
template <bool kBorder>
__device__ __forceinline__ Cell narrow_cell(const float* __restrict__ hwd,
                                            int64_t n, int H, int W, int D) {
  float h = hwd[3 * n], w = hwd[3 * n + 1], d = hwd[3 * n + 2];
  if constexpr (kBorder) {
    h = fminf(fmaxf(h, 0.f), static_cast<float>(H - 1));
    w = fminf(fmaxf(w, 0.f), static_cast<float>(W - 1));
    d = fminf(fmaxf(d, 0.f), static_cast<float>(D - 1));
  }
  return cell_of(h, w, d);
}

// Corner k's voxel. kBorder: the clipped cell's upper corners clamped onto
// the face rows, where their weight is 0 (interp.py:145-148); zeros: -1
// outside the volume.
template <bool kBorder>
__device__ __forceinline__ int narrow_voxel(const Cell& c, int k, int H,
                                            int W, int D) {
  if constexpr (kBorder)
    return (min(c.h0 + (k >> 2), H - 1) * W +
            min(c.w0 + ((k >> 1) & 1), W - 1)) * D +
           min(c.d0 + (k & 1), D - 1);
  else
    return in_volume(c, k, H, W, D) ? voxel(c, k, W, D) : -1;
}

// d clip(x, 0, hi) / dx as JAX autodiff gives jnp.clip's: a maximum, then
// a minimum, each passing half of the gradient at a tie.
__device__ __forceinline__ float clip_slope(float x, float hi) {
  const float m = fmaxf(x, 0.f);
  return (x > 0.f ? 1.f : x == 0.f ? 0.5f : 0.f) *
         (m < hi ? 1.f : m == hi ? 0.5f : 0.f);
}

// vol is (H, W, D, C) with `row` >= C floats between voxels. Each thread
// issues its point's 8 x C scalar loads before the sum (the flow volume,
// 19.8 MB, stays in L2) and the warp's 32 x C values go out through shared
// memory as C coalesced stores.
template <int C, bool kBorder>
__global__ void __launch_bounds__(kThreads)
    values_fwd_narrow_kernel(const float* __restrict__ vol,
                             const float* __restrict__ hwd,
                             float* __restrict__ vals, int64_t num_points,
                             int H, int W, int D, int64_t row) {
  __shared__ float stage[kWarps][C * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
  if (n < num_points) {
    const Cell c = narrow_cell<kBorder>(hwd, n, H, W, D);
    float v[8][C];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = narrow_voxel<kBorder>(c, k, H, W, D);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        v[k][ch] = vox >= 0 ? __ldg(vol + static_cast<int64_t>(vox) * row + ch)
                            : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = weight(c, k);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[ch] += w * v[k][ch];
    }
  }
  store_rows<C>(stage[warp], vals, tile, num_points, lane, acc);
}

// acc is the zeroed (H, W, D, 4) scratch, which narrow_fold_kernel turns
// into the (H, W, D, C) gradient. Lanes over points, not channels: the
// lanes of a warp whose points lie in one cell (consecutive lanes) sum
// their 8 x C contributions by a segmented shuffle scan, as plane_seg does
// at C = 1, with only as many steps as the warp's longest segment needs;
// each segment's last lane makes one float4 atomic a corner row of the
// scratch (a 12-byte row of the gradient is never 16-byte aligned), none
// for a row of exact zeros (a border point on an upper face gives its
// upper corners weight 0).
//
// kPoints: also the points' cotangent (N, 3) into gpts, from the 8 corner
// rows of vol (`row` floats between voxels) that each lane loads: the
// slopes of the interpolant, times clip_slope of each index with kBorder.
template <int C, bool kBorder, bool kPoints>
__global__ void __launch_bounds__(kThreads)
    values_bwd_narrow_kernel(const float* __restrict__ hwd,
                             const float* __restrict__ gv,
                             float4* __restrict__ acc, int64_t num_points,
                             int H, int W, int D,
                             const float* __restrict__ vol, int64_t row,
                             float* __restrict__ gpts) {
  __shared__ float stage[kPoints ? kWarps : 1][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  // points past the end: a cell with no corner in the volume, which no
  // live border point has
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  float g[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) g[ch] = 0.f;
  if (live) {
    c = narrow_cell<kBorder>(hwd, n, H, W, D);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g[ch] = gv[n * C + ch];
  }
  if constexpr (kPoints) {
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = live ? narrow_voxel<kBorder>(c, k, H, W, D) : -1;
      s[k] = 0.f;
      if (vox >= 0) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          s[k] += g[ch] * __ldg(vol + static_cast<int64_t>(vox) * row + ch);
      }
    }
    float cot[3];
    point_cotangent(c, s, s, 0.f, 0.f, 0.f, cot);
    if constexpr (kBorder) {
      if (live) {
        cot[0] *= clip_slope(hwd[3 * n], static_cast<float>(H - 1));
        cot[1] *= clip_slope(hwd[3 * n + 1], static_cast<float>(W - 1));
        cot[2] *= clip_slope(hwd[3 * n + 2], static_cast<float>(D - 1));
      }
    }
    store_rows<3>(stage[warp], gpts, tile, num_points, lane, cot);
  }
  const int ph = __shfl_up_sync(kFull, c.h0, 1);
  const int pw = __shfl_up_sync(kFull, c.w0, 1);
  const int pd = __shfl_up_sync(kFull, c.d0, 1);
  const unsigned heads = __ballot_sync(
      kFull, lane == 0 || c.h0 != ph || c.w0 != pw || c.d0 != pd);
  const int start = 31 - __clz(heads & upto);
  const unsigned later = heads & ~upto;
  const bool last = later ? __ffs(later) - 2 == lane : lane == kWarp - 1;
  // the scan covers positions up to the longest segment's last
  const int longest = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(lane - start)));
  float x[8][C];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = weight(c, k);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) x[k][ch] = w * g[ch];
  }
  for (int d = 1; d <= longest; d <<= 1) {  // warp-uniform
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float y = __shfl_up_sync(kFull, x[k][ch], d);
        if (lane - d >= start) x[k][ch] += y;
      }
    }
  }
  if (last && live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = narrow_voxel<kBorder>(c, k, H, W, D);
      float4 v = make_float4(x[k][0], 0.f, 0.f, 0.f);
      if constexpr (C > 1) v.y = x[k][C > 1 ? 1 : 0];
      if constexpr (C > 2) v.z = x[k][C > 2 ? 2 : 0];
      if (vox >= 0 && (v.x != 0.f || v.y != 0.f || v.z != 0.f))
        atomicAdd(acc + vox, v);
    }
  }
}

// grad (H, W, D, C) = the first C floats of each row of the narrow
// backward's (H, W, D, 4) scratch; one thread an element, every element.
__global__ void __launch_bounds__(kThreads)
    narrow_fold_kernel(const float4* __restrict__ acc,
                       float* __restrict__ grad, int64_t voxels, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < voxels * C)
    grad[i] = reinterpret_cast<const float*>(acc + i / C)[i % C];
}

unsigned blocks_for(int64_t num_points) {
  return static_cast<unsigned>((num_points + kThreads - 1) / kThreads);
}

unsigned seg_blocks(int64_t num_points) {
  return static_cast<unsigned>((num_points + kThreads * kSegTiles - 1) /
                               (kThreads * kSegTiles));
}

template <bool kBorder>
void narrow_fwd(const float* vol, const float* hwd, float* vals,
                int64_t num_points, int C, int H, int W, int D, int64_t row,
                cudaStream_t s) {
  const unsigned blocks = blocks_for(num_points);
  if (C == 1)
    values_fwd_narrow_kernel<1, kBorder><<<blocks, kThreads, 0, s>>>(
        vol, hwd, vals, num_points, H, W, D, row);
  else if (C == 2)
    values_fwd_narrow_kernel<2, kBorder><<<blocks, kThreads, 0, s>>>(
        vol, hwd, vals, num_points, H, W, D, row);
  else
    values_fwd_narrow_kernel<3, kBorder><<<blocks, kThreads, 0, s>>>(
        vol, hwd, vals, num_points, H, W, D, row);
}

// The narrow backward into the zeroed scratch acc (H W D float4s), then
// its fold into grad, every element; vol and gpts: null for the point-free
// instance.
template <bool kBorder, bool kPoints>
void narrow_bwd(const float* hwd, const float* gv, float* grad, float* acc,
                int64_t num_points, int C, int H, int W, int D,
                const float* vol, int64_t row, float* gpts, cudaStream_t s) {
  const unsigned blocks = blocks_for(num_points);
  float4* rows = reinterpret_cast<float4*>(acc);
  if (num_points > 0) {
    if (C == 1)
      values_bwd_narrow_kernel<1, kBorder, kPoints>
          <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D,
                                       vol, row, gpts);
    else if (C == 2)
      values_bwd_narrow_kernel<2, kBorder, kPoints>
          <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D,
                                       vol, row, gpts);
    else
      values_bwd_narrow_kernel<3, kBorder, kPoints>
          <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D,
                                       vol, row, gpts);
  }
  const int64_t voxels = static_cast<int64_t>(H) * W * D;
  if (voxels > 0)
    narrow_fold_kernel<<<blocks_for(voxels * C), kThreads, 0, s>>>(
        rows, grad, voxels, C);
}

}  // namespace

// vol: (H, W, D, C) channel-last (the (H, W, D) plane when C = 1); hwd
// (N, 3); vals (N, C) and grad0 (N, 3) written.
extern "C" int trilinear_cf_with_grad_fwd(const float* vol, const float* hwd,
                                          float* vals, float* grad0,
                                          int64_t num_points, int C, int H,
                                          int W, int D, void* stream) {
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1)
      trilinear_fwd_plane_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          vol, hwd, vals, grad0, num_points, H, W, D);
    else
      trilinear_fwd_rows_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          vol, hwd, vals, grad0, num_points, C, H, W, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// The values-only forward: vals (N, C) written. vol: (H, W, D, C) with
// channels contiguous and `row` >= C floats between consecutive voxels, so
// that a slice of channels of a wider channel-last tensor (the occupancy
// query's sdf or logits out of its (N, 25) values) is read in place. At
// most kStageFloats / 4 = 2048 channels. `border`: "border" padding, which
// the narrow instances alone implement (C <= kNarrowMax); else zeros.
extern "C" int trilinear_cf_fwd(const float* vol, const float* hwd,
                                float* vals, int64_t num_points, int C, int H,
                                int W, int D, int64_t row, int border,
                                void* stream) {
  if (C > kStageFloats / 4 || (border && C > kNarrowMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1 && !border) {
      values_fwd_plane_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          vol, hwd, vals, num_points, H, W, D, row);
    } else if (C <= kNarrowMax) {
      if (border)
        narrow_fwd<true>(vol, hwd, vals, num_points, C, H, W, D, row, s);
      else
        narrow_fwd<false>(vol, hwd, vals, num_points, C, H, W, D, row, s);
    } else if (C == 4 && row % 4 == 0 &&
               aligned16(vol) && aligned16(vals)) {
      values_fwd_vec4_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(vol), hwd,
          reinterpret_cast<float4*>(vals), num_points, H, W, D, row / 4);
    } else if (C <= kWarp) {
      values_fwd_walk_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          vol, hwd, vals, num_points, C, H, W, D, row);
    } else {
      const int cap = (kStageFloats / C) & ~3;
      const int tile = cap < kTileMax ? cap : kTileMax;
      const size_t smem = static_cast<size_t>(tile) * (C + 10) * 4;
      values_fwd_rows_kernel<<<static_cast<unsigned>(
                                   (num_points + tile - 1) / tile),
                               kThreads, smem, s>>>(
          vol, hwd, vals, num_points, C, H, W, D, row, tile,
          aligned16(vals));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The values-only backward: gv (N, C), the values' cotangent; grad (H, W,
// D, C) channel-last. `border`: as trilinear_cf_fwd's. The narrow
// instances (C <= kNarrowMax but for C = 1 with zeros padding) sum into
// acc, a zeroed (H, W, D, 4) scratch, and write every element of grad;
// the others accumulate into grad, zeroed by the caller (acc unused).
extern "C" int trilinear_cf_bwd(const float* hwd, const float* gv,
                                float* grad, float* acc, int64_t num_points,
                                int C, int H, int W, int D, int border,
                                void* stream) {
  if (border && C > kNarrowMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((C > 1 || border) && C <= kNarrowMax) {
    if (border)
      narrow_bwd<true, false>(hwd, gv, grad, acc, num_points, C, H, W, D,
                              nullptr, 0, nullptr, s);
    else
      narrow_bwd<false, false>(hwd, gv, grad, acc, num_points, C, H, W, D,
                               nullptr, 0, nullptr, s);
  } else if (num_points > 0) {
    const Hot none{nullptr, nullptr, nullptr, 0};
    if (C == 1)
      values_bwd_plane_seg_kernel<<<seg_blocks(num_points), kThreads, 0, s>>>(
          hwd, gv, grad, num_points, H, W, D);
    else if (C % 4 == 0 && aligned16(gv) && aligned16(grad))
      values_bwd_rows_kernel<<<blocks_for(num_points * (C / 4)), kThreads, 0,
                               s>>>(hwd, gv, grad, num_points, C, H, W, D);
    else
      values_bwd_walk_kernel<false><<<blocks_for(num_points), kThreads, 0,
                                      s>>>(hwd, gv, grad, num_points, C, H,
                                           W, D, nullptr, 0, nullptr, none);
  }
  return static_cast<int>(cudaGetLastError());
}

// gv (N, C) or null, gg (N, 3) or null; grad (H, W, D, C) channel-last,
// zeroed by the caller.
extern "C" int trilinear_bwd(const float* hwd, const float* gv,
                             const float* gg, float* grad, int64_t num_points,
                             int C, int H, int W, int D, void* stream) {
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Hot none{nullptr, nullptr, nullptr, 0};
    if (C == 1)
      trilinear_bwd_plane_kernel<false><<<blocks_for(num_points), kThreads, 0,
                                          s>>>(hwd, gv, gg, grad, num_points,
                                               H, W, D, nullptr, nullptr,
                                               nullptr);
    else
      trilinear_bwd_rows_kernel<false><<<blocks_for(num_points), kThreads, 0,
                                         s>>>(hwd, gv, gg, grad, num_points,
                                              C, H, W, D, nullptr, nullptr,
                                              none);
  }
  return static_cast<int>(cudaGetLastError());
}

// The hot cells' counts before a point instance, and its fp64 rows added
// to grad after it.
static void hot_count(const Hot& hot, const float* hwd, int64_t num_points,
                      int H, int W, int D, cudaStream_t s) {
  hot_count_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
      hwd, num_points, H, W, D, const_cast<int*>(hot.counts));
}

static void hot_fold(const Hot& hot, float* grad, int C, cudaStream_t s) {
  hot_fold_kernel<<<static_cast<unsigned>(
                        (static_cast<int64_t>(kHotSlots) * C + kThreads - 1) /
                        kThreads),
                    kThreads, 0, s>>>(hot.keys, hot.sums, grad, C);
}

// trilinear_bwd with the points' cotangent at C > 1: vol (H, W, D, C)
// channel-last, the forward's volume; gpts (N, 3), every row written.
// hot_counts (H W D int32, 0), hot_keys (kHotSlots int32, -1) and hot_sums
// (kHotSlots x C doubles, 0): the hot cells' counts and fp64 rows
// (hot_add). C = 1 is trilinear_plane_points_bwd.
extern "C" int trilinear_bwd_points(const float* vol, const float* hwd,
                                    const float* gv, const float* gg,
                                    float* grad, float* gpts,
                                    int64_t num_points, int C, int H, int W,
                                    int D, int* hot_counts, int* hot_keys,
                                    double* hot_sums, void* stream) {
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Hot hot{hot_counts, hot_keys, hot_sums, H * W * D};
    hot_count(hot, hwd, num_points, H, W, D, s);
    // the staged cotangent rows: 32 KB, beside 20 KB of static memory
    const int staged = kWarps * kWarp * kWarp * 4;
    cudaFuncSetAttribute(trilinear_bwd_rows_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
    trilinear_bwd_rows_kernel<true><<<blocks_for(num_points), kThreads,
                                      staged, s>>>(
        hwd, gv, gg, grad, num_points, C, H, W, D, vol, gpts, hot);
    hot_fold(hot, grad, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// trilinear_cf_bwd with the points' cotangent at C > 1 or with `border`:
// vol (H, W, D, C), `row` floats between voxels, the forward's volume; gpts
// (N, 3), every row written. C <= kNarrowMax: the narrow instance, with
// acc and grad as trilinear_cf_bwd's (the hot arguments unused, null);
// else the walk into grad, zeroed by the caller, with hot_counts,
// hot_keys, hot_sums as trilinear_bwd_points' (acc unused). C = 1 with
// zeros padding is trilinear_plane_points_bwd.
extern "C" int trilinear_cf_bwd_points(const float* vol, int64_t row,
                                       const float* hwd, const float* gv,
                                       float* grad, float* acc, float* gpts,
                                       int64_t num_points, int C, int H,
                                       int W, int D, int* hot_counts,
                                       int* hot_keys, double* hot_sums,
                                       int border, void* stream) {
  if (border && C > kNarrowMax) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= kNarrowMax) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border)
      narrow_bwd<true, true>(hwd, gv, grad, acc, num_points, C, H, W, D, vol,
                             row, gpts, s);
    else
      narrow_bwd<false, true>(hwd, gv, grad, acc, num_points, C, H, W, D, vol,
                              row, gpts, s);
  } else if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Hot hot{hot_counts, hot_keys, hot_sums, H * W * D};
    hot_count(hot, hwd, num_points, H, W, D, s);
    values_bwd_walk_kernel<true><<<blocks_for(num_points), kThreads, 0, s>>>(
        hwd, gv, grad, num_points, C, H, W, D, vol, row, gpts, hot);
    hot_fold(hot, grad, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The C = 1 point instances, both cotangents of trilinear_bwd (gg (N, 3) or
// null; row 1) or of trilinear_cf_bwd (gg null): vol the forward's (H, W, D)
// plane, `row` floats between voxels; acc H W D doubles, zeroed by the
// caller; grad the (H, W, D) plane, every element written; gpts (N, 3),
// every row written. Three launches in all with the caller's fill: the
// segments (kSegTiles tiles a block) and the fold.
extern "C" int trilinear_plane_points_bwd(const float* vol, int64_t row,
                                          const float* hwd, const float* gv,
                                          const float* gg, double* acc,
                                          float* grad, float* gpts,
                                          int64_t num_points, int H, int W,
                                          int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_points > 0) {
    const int tiles = kSegTiles;
    const unsigned blocks = static_cast<unsigned>(
        (num_points + kThreads * tiles - 1) / (kThreads * tiles));
    if (gg != nullptr)
      trilinear_bwd_plane_points_kernel<<<blocks, kThreads, 0, s>>>(
          hwd, gv, gg, acc, num_points, H, W, D, vol, gpts, tiles);
    else
      values_bwd_plane_points_kernel<<<blocks, kThreads, 0, s>>>(
          hwd, gv, acc, num_points, H, W, D, vol, row, gpts, tiles);
  }
  const int64_t voxels = static_cast<int64_t>(H) * W * D;
  if (voxels > 0)
    trilinear_plane_fold_kernel<<<blocks_for(voxels), kThreads, 0, s>>>(
        acc, grad, voxels);
  return static_cast<int>(cudaGetLastError());
}
