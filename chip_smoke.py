"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the twenty-four CUDA kernels from vpcc_tpu_torch/csrc (one nvcc
   per source, all started together) and prints the build seconds;

the decode path (kernels A-D, K's apply entry and Q's color conversion):
3. decodes the committed 8-frame vox10 fixture once (warm-up), keeping each
   kernel's largest call as its main-path input (for the wavefront decode,
   the largest with the most inter-coded samples: a P-frame plane; for
   kernel Q, a 1280x1280 T0 image each way; for `sao_apply`, the largest
   stack of decoded planes);
4. runs each kernel and its plain PyTorch version on those inputs on the
   card, requires identical results, and times both in turns
   (plain, kernel, kernel, plain; CUDA events); holds kernel O against its
   plain version on every deblock call of the warm-up decode, and kernel
   Q's entries (the chroma tensor against the plain cb and cr, stacked);
   runs O's largest call and each Q entry once under
   torch.cuda.set_sync_debug_mode("error") in one launch, with call and
   device times; holds kernel C against its plain version on every call of
   the warm-up decode (all five fields, two launches a call, the largest
   with one host synchronisation under sync debug mode "warn", its call
   and device times); holds kernel D against its plain version on every
   call of the warm-up decode (one launch a call, the largest under sync
   debug mode "error", its call and device times and the bytes of cell
   records it sets), and kernel B on every call of the warm-up decode (one
   launch a call, the largest under sync debug mode "error", its call and
   device times);
5. with all launch counters at 0, decodes the fixture again with
   `vpcc_tpu_torch.Decoder(device="cuda")`, checks every frame's point count
   and md5 against the digests the JAX decoder recorded, prints warm seconds
   per frame, and requires every kernel to have launched on that path
   (Q included), kernels A, B, K, O, D and each entry of Q once a call, C
   twice;

the encoder front end (kernels E-H):
6. makes the 8 bench frames from their seeds and runs
   `vpcc_tpu_torch.encoder.Encoder(cfg, device="cuda").encode_gof_front`
   once (warm-up), keeping each kernel's largest call and every call of
   kernel G (`cc_labels_device`, one a patch round);
7. holds each kernel against its plain version there (k-NN, CC labels and
   coverage exactly; the segment kernel's partitions exactly given the same
   normals, its normals to NORMAL_ATOL, its device centroid equal to the
   tensor twin, and its chain run again under
   torch.cuda.set_sync_debug_mode("error") in CHAIN_LAUNCHES launches)
   and times both in turns (the bound counts the sweeps the chain ran);
   holds every captured kernel G call exactly and times round 0 and the
   sparsest round (call and device times); holds every kernel H call of the
   warm-up bit for bit, one launch a call, runs the largest frame's round 0
   under sync debug mode "error" and times each of its rounds (call and
   device times);
8. with all launch counters at 0, runs the front end over the GOF again,
   prints warm seconds per frame and the stage split, requires the k-NN
   digests to equal the JAX package's and the partition agreement to reach
   PARTITION_FLOOR, and requires every kernel E-H to have launched, G three
   times a call, F CHAIN_LAUNCHES times a chain, H once a call;
9. runs the patch-generation half driven by the committed JAX partitions
   and requires all 8 frames' patches, atlas, occupancy video and
   block-to-patch to equal the JAX digests;

the geometry video encoder (kernels I-L; the decode path above also runs
kernel K's apply):
10. runs `Encoder(cfg, device="cuda").encode_gof_geometry` over the 8 bench
    frames driven by the committed JAX partitions (their atlas frames are
    the JAX package's) once (warm-up), keeping each kernel's largest call
    (for the wavefront encode, a motion-searched P-frame plane);
11. holds kernel J against its plain version on every captured call of the
    warm-up (vectors and rates bit for bit), and each kernel against its
    plain version on its largest call (syntax, MVs, SAO
    parameters and planes identical; kernel K's `sao_search_apply`, the
    encoder's one launch, against the plain search then apply and against
    its own `sao_search` then `sao_apply`) and times both in turns, and kernel L
    on crafted planes whose push sums pass 2^24 (256x256 and 512x512 in
    XLA's probed orders, a 3-plane stack with an occupancy per plane, a
    1216x1280 plane whose order is not established: the same count of such
    blocks), and kernels L and B on every call of the warm-up (L in the
    launches its tile plan makes, at most three; B once a call; the largest
    of each under sync debug mode "error");
12. with all launch counters at 0, runs the GOF again, prints warm seconds
    per frame, the stage split and the device idle share of one warm
    P-frame (`torch.profiler`), and requires: all 16 geometry payloads to
    decode exactly to the encoder's planes with the port's decoder; L's
    launches as its tile plan says and B's one a call; the
    encoder's reconstruction to equal `pipeline.reconstruct_frame` on
    those planes; GOF geometry bytes within RD_BYTES_TOL and every
    plane's occupied-pixel PSNR within RD_PSNR_TOL_DB of the JAX encoder's
    geometry substreams in the committed fixture (JAX's planes are the
    port decoder's output on them, which step 5 holds exact); and kernels
    I-L to have launched, K once a call.  It prints the share of 32x32 CUs
    whose syntax equals JAX's, per plane;

the attribute path and the whole encoder (kernels M-P and Q; the decode
path above also runs kernels O, P and Q):
13. runs `Encoder(cfg, device="cuda").encode_gof` over the 8 bench frames
    driven by the committed JAX partitions once (warm-up, cold seconds),
    keeping each kernel's largest call, and holds kernels M (its two
    entries: the exact match with the compaction, and the forward blend,
    splat and merge, on every recolor call of the warm-up, two launches a
    call, the largest transfer with one host synchronisation), N (its
    vote writing into a copy of the colors at the boundary rows), O, P
    (paint, group dilation, gather) and Q (both directions, a 1280x1280
    T0 image) against their plain versions, exactly, timing both in turns;
    kernel N's whole call (the warm-up's largest `presmooth_colors`: the
    boundary rows, kernel E's k=64 sweep, the vote) against the same call
    with the plain vote (md5 equal), timing both in turns;
    kernel O on every deblock call of the warm-up, O and Q once under sync
    debug mode "error" in one launch a call (the spy that measures each
    attribute plane converts with the unwrapped entry: no encoder call),
    kernels C and D on every call of the warm-up as in step 4, and kernels
    L (the geometry planes and `fill_rgb`'s six attribute planes under one
    occupancy) and B on every call of the warm-up as in step 11;
14. decodes the fixture's geometry with the port (JAX's reconstruction
    rows) and runs the port's recolor -> pre-smoothing -> paint -> fill ->
    group dilation on it with the regenerated source frames; the md5 of the
    transferred and pre-smoothed colors and of the final T0/T1 images must
    equal the JAX encoder's (person_vox10_attr_digests.json) on all frames;
15. with all launch counters at 0, segments the frames, drives their
    partitions and runs `encode_gof` again: warm seconds per frame, the
    stage split, launches (every kernel the encoder runs, B-Q, nonzero; B,
    K, O, D and each Q entry once a call, M twice, L as its tile plan says,
    with O's and Q's calls a frame), no
    push-pull block of unknown order reaching 2^24, the
    device idle share of one warm P-frame and kernels E, G and K's share of
    its trace (and O's and Q's); then requires the port's
    decoder to decode the stream exactly to the encoder's reconstruction
    (point counts and md5, all frames), the stream bytes within
    RD_BYTES_TOL of the fixture's and every attribute plane's occupied-pixel
    luma PSNR within RD_PSNR_TOL_DB of the JAX encoder's, and prints the
    bytes per substream beside JAX's;

the quality metrics and the RD curve (kernel R, over kernels E and F):
16. with all launch counters at 0, measures the port's decode of the
    fixture (step 5, equal to JAX's) against the regenerated source frames
    with `ops.metrics.compute_metrics` and the sources' `estimate_normals`,
    as bench.py does; requires kernel R to have launched once a call,
    every frame's D1 MSE and Hausdorff term to equal the JAX package's
    (person_vox10_rd_reference.json, made by
    tests/torch_make_rd_reference.py) and its D1/D2/Y/U/V PSNRs to lie
    within METRICS_PSNR_TOL_DB of them; prints frame 0's host
    synchronisations (sync debug mode "warn") beside its grid misses;
17. holds kernel R's one launch over frame 0's two directions against its
    plain version (the maximum d2 and the float32 D1 sum bit for bit,
    float64 sums to R_FLOAT_RTOL, repeated launches bit for bit equal) and
    times both in turns, and the unit with its host read;
18. encodes the 8 frames at r1 and r5 (CTC QPs, JAX partitions) and, with
    step 15's r3 stream, requires each rate's stream bytes within
    RD_BYTES_TOL and mean D1/D2/Y within RD_PSNR_TOL_DB of the JAX
    encoder's, and prints whether each stream is byte-identical to it;
19. prints the port's r1/r3/r5 curve beside JAX's;

the vox11 path (11-bit geometry: kernel E's unpacked-table entry, the
full-graph CC round on kernel G, kernel M's uncompacted blend):
21. makes the two vox11 frames (`make_person_cloud(bits=11,
    n_samples=12_000_000)`, seeds 7 and 8) and checks their point counts
    against person_vox11_reference.json (tests/torch_make_vox11_reference.py);
22. runs `Encoder(cfg, device="cuda").encode_gof` on them, driven by the
    committed JAX partitions (person_vox11_partitions.npz), once (warm-up),
    keeping each entry's largest call;
23. holds `grid_knn_xyz` (kernel E on the (N, 3) table), `cc_round_voxel`
    (kernel G on the full voxel graph) and `recolor_blend` (kernel M's
    blend entry over every target and every source) against their plain
    versions, exactly, timing both in turns; kernel M's blend entry on
    every `transfer_colors` call of the warm-up (one launch a call, the
    largest transfer under sync debug mode "error") and kernel D on every
    call (256^3 cells) as in step 4;
24. with all launch counters at 0, segments the frames, drives their
    partitions and runs `encode_gof` again: warm seconds per frame, the
    stage split, and each entry launched (M and D once a call);
25. requires the voxel k-NN, each patch round's CC labels, the patch list,
    the coverage distances, the transferred and pre-smoothed colors and the
    reconstruction to equal the JAX digests, the stream to be
    byte-identical to the JAX encoder's, and the port's decoder to decode
    it exactly to the encoder's reconstruction (decode seconds per frame);
26. measures the reconstruction with `compute_metrics(grid_bits=11)` and
    the sources' `estimate_normals`: Hausdorff equal to JAX's, D1 MSE within
    VOX11_D1_MSE_ULPS (0) float32 ulps of it, D1/D2/Y/U/V within
    METRICS_PSNR_TOL_DB (seconds per frame);

the CTC's lossless conditions (kernel C's EOM entry, kernel S; reference
data person_vox10_lossless_reference.json, made by
tests/torch_make_lossless_reference.py):
28. runs `Encoder(cfg, device="cuda").encode_gof` on the first four bench
    frames under the lossless overrides (lossless video, raw points, EOM,
    the separate RAW/EOM video), driven by the JAX partitions, once
    (warm-up), keeping the largest call of kernel C's EOM entry and of
    kernel S's extract and inject;
29. holds both against their plain versions, exactly, timing both in turns
    (three rounds, to show the spread within one run), and kernel C's EOM
    entry on every call of the warm-up as in step 4;
30. with all launch counters at 0, encodes again: warm seconds per frame,
    the stage split, launches (C's EOM entry and S nonzero);
31. requires the patch, raw-point, EOM-code and EOM-row counts, the EOM
    planes, the raw points and the reconstructions to equal JAX's, the
    stream to be byte-identical to the JAX encoder's (or, where this
    interpreter's zlib is another build than the reference run's, says the
    bytes are not comparable), the port's decoder to decode it to the
    encoder's reconstruction and every decoded frame to equal its source
    bit for bit; prints decode seconds per frame, the decoder's launches
    (counters at 0 before the decode) and the bytes per substream beside
    JAX's;
32. encodes the first two frames under r3 with EOM: the stream must be
    byte-identical to JAX's and decode to the encoder's reconstruction;

the reconstruction tools a stream signals to the decoder (kernels T, U, V
and kernel C's PLR use; reference data person_vox10_tools_reference.json,
made by tests/torch_make_tools_reference.py), on the first two bench
frames, driven by the JAX partitions, under three configurations: "cs"
(r3 + color smoothing), "pbf" (r1 QPs, occupancyPrecision 4, PBF) and
"plr" (r3 + PLR); per configuration:
33. a warm-up encode keeping the largest call of the tool's kernels (for
    "plr", kernel C's PLR use held on every call as in step 4);
34. holds them against their plain versions, exactly (kernel U's border
    count too), timing both in turns;
35. with all launch counters at 0, encodes again: warm seconds per frame,
    the stage split, launches (the tool's kernels nonzero);
36. requires the stream to be byte-identical to the JAX encoder's, every
    frame's reconstruction digest and, per tool, its PBF-filtered occupancy
    (md5 and kept pixels), PLR block-mode map or smoothed colors (md5) to
    equal JAX's, no PLR RDO block or small patch whose sums reach 2^24
    (where XLA's reduce order would decide the rounding), and the port's
    decoder to decode the stream to the encoder's reconstruction (decode
    seconds per frame, the decoder's launches);

the attribute options (the reflectance attribute and attributeBGFill 0 /
2: kernel W's dilation and harmonic entry, kernel P's scalar entries;
reference data person_vox10_attr_options_reference.json, made by
tests/torch_make_attr_options_reference.py), on the first two bench frames,
driven by the JAX partitions, under four configurations: "refl" (r3 with a
seeded reflectance attribute, lossy), "refl_lossless" (the lossless
conditions with reflectance), "bgfill0" and "bgfill2" (r3 with the sparse
dilation and the harmonic fill); per configuration:
37. a warm-up encode keeping the largest call of the configuration's new
    entries (for reflectance also kernels I and A on the reflectance
    planes), and kernel O against its plain version on every deblock call
    of the warm-up encode and decode (for "refl" the 10-bit reflectance
    planes, maxval 1023, among them);
38. holds them against their plain versions, exactly, timing both in turns
    (the dilation as the main path calls it, rounded, its float planes and
    pass count too, at most 3 launches and 1 host read a call; for
    "bgfill2" also the smoothed push-pull `smooth_fill`, which nothing
    calls, and for "refl" `transfer_reflectance` over kernels M and E);
39. with all launch counters at 0, encodes again: warm seconds per frame,
    the stage split, launches (the new entries nonzero), the dilation passes
    per image;
40. requires the stream's md5, length and `last_stream_stats`, per frame the
    transferred reflectances, the T0/T1 images the attribute video codes and
    the reconstruction (positions, colors, reflectances) to equal JAX's, the
    port's decoder to decode the stream to the encoder's reconstruction,
    reflectances included (decode seconds per frame), and for "refl" each
    frame's reflectance PSNR within METRICS_PSNR_TOL_DB of JAX's;
then the dilation on the crafted cases of tests/torch_frontier.py (torus
wrap, sides of 1 and 2, the cap, empty and full occupancy), exactly, with
3 launches and 1 host read a call;

the segmentation options (normalOrientation 0 / 2 / 4: kernel X;
highGradientSeparation: kernel F's high-gradient entry; ROI partitioning)
and tetris packing (reference data person_vox10_seg_options_reference.json
and person_vox10_seg_options_partitions.npz, made by
tests/torch_make_seg_options_reference.py), on the first two bench frames:
41. segments both frames with the port's own segmentation under
    normalOrientation 0, 2, 4 and with highGradientSeparation, and requires
    each voxel partition to agree with the JAX package's at PARTITION_FLOOR
    (printed, with mode 4's flood sweeps and, given JAX's partition, the
    agreement of the high-gradient aux);
per configuration ("orient0", "orient2", "orient4" with the port's own
segmentation; "hgs" driven by the JAX partitions and the JAX voxel aux,
"roi" by each chunk's JAX partitions through a subclass that swaps them in
with `Encoder.with_partition`, "tetris" by the JAX partitions):
42. a warm-up encode keeping the largest call of the configuration's new
    entry;
43. with all launch counters at 0, encodes again: cold and warm seconds per
    frame, the stage split, launches (the new entry and kernels E-H nonzero;
    roi's chunk point counts equal to JAX's);
44. requires hgs, roi and tetris to be byte-identical to the JAX encoder's
    stream (patches and reconstructions too), the stream bytes of orient0,
    orient2 and orient4 within RD_BYTES_TOL and their mean D1/D2/Y within
    RD_PSNR_TOL_DB of JAX's, and the port's decoder to decode every stream
    to the encoder's reconstruction;
45. holds `orient_viewpoint`, the flood (`orient`, its sweep count too, at
    most 3 launches and 1 host read a call) and `high_gradient_aux` against
    their plain versions on their largest calls, exactly, timing both in
    turns; then the flood on the crafted cases of tests/torch_frontier.py (a
    vote that cancels and is signed later, a disconnected component,
    pad_rows, V = 0, a random graph), exactly, with 3 launches and 1 host
    read a call;

the level-batched GOF path (`encode_gof(parallel=True)`: every video
dispatch and the recolor batch the frames of one hierarchy level; kernel
E's and M's frame-batched entries), on the 8 bench frames at r3 driven by
the JAX partitions:
47. a cold encode, keeping the largest call of each batched entry, and the
    level groups (level, shape, inter or intra, frames); holds kernels J and
    O against their plain versions on every call (the level's plane stacks),
    kernel Q's `rgb_to_planes` on every call (a level's images, one batch a
    call), kernel M's batched entries on every call (one launch each, no
    host synchronisation), kernels C and D on every call as in step 4, and
    kernels L (the stacks with an occupancy per plane) and B on every call
    as in step 11;
48. with all launch counters at 0, warm encodes in turns (sequential,
    level-batched, level-batched, sequential): seconds per frame of each,
    the stage split, launches per level group (every kernel of the path
    nonzero, B, K, O, D, each Q entry and each batched M entry once a call,
    L as its tile plan says),
    no push-pull block of
    unknown order reaching
    2^24; requires
    the stream to be byte-identical to the sequential r3 stream and to the
    JAX encoder's fixture, and the port's decoder to decode it to the
    encoder's reconstruction;
49. the device idle share of the largest warm level group (its profiler
    range);
50. holds `grid_knn_batch`, `recolor_exact_batch` and `recolor_blend_batch`
    against their plain versions and against B launches of the single-frame
    entries, exactly, timing the three in turns;
the two-level (16/8) codec of planes above 10 bits (kernel I's and kernel
A's two-level entries; J and B at 16-px CUs, K at 16-px regions, L on 11-bit
planes; reference data person_vox11_geo11_reference.json, made by
tests/torch_make_geo11_reference.py), on the vox11 frames of step 21 at
geometryNominal2dBitdepth=11 and r3, driven by the JAX partitions:
52. with all launch counters at 0, runs `encode_gof` once, keeping the
    largest call of kernel I's two-level entry and of the plane dispatch:
    seconds per frame, the stage split, launches (I's two-level entry, K and
    L nonzero, K and B once a call, L as its tile plan says, K's largest
    16-px call held against the plain search then apply and against its two
    entries, L on every call as in step 11), the geometry samples
    above 1023 per plane beside JAX's, no
    push-pull block of unknown order reaching 2^24, and every geometry
    payload's flags (FLAG_SAO16, not FLAG_CU32) equal to JAX's;
53. requires the stream to be byte-identical to the JAX encoder's and every
    frame's reconstruction to equal JAX's digest (or else its bytes and mean
    D1/D2/Y within RD_BYTES_TOL / RD_PSNR_TOL_DB of JAX's, with each
    geometry payload's identity printed), and, counters at 0, the port's
    decoder to decode it to the encoder's reconstruction (kernel A's
    two-level entry launched), keeping that entry's largest call, and holds
    the decode's largest 16-px `sao_apply` call against its plain version;
54. holds both two-level entries against their plain versions, exactly, on
    the GOF's largest calls, on a motion-searched P-plane of that content
    (its decoded plane shifted by (3, -2) as the reference) and on a crafted
    1280x1280 random-walk plane spanning 0..2047 (each payload decoding to
    the encoder's planes), timing the kernels (2 x 5 launches) and the plain
    versions (one run) on the GOF's calls; holds kernel J at 16-px CUs
    against its plain version on every call of the GOF and the P-plane and
    times the largest, and kernel B at 16-px CUs on every call of the GOF
    and of the P-plane's encode and decode as in step 11;
55. runs `apps/video_codec.py` encode and decode on three 256x256 11-bit
    depth frames and requires the decode to equal the geometry coder's
    reconstruction;
the packing options, on the 8 bench frames at r3 driven by the JAX
partitions (reference data person_vox10_gpa_tiles_reference.json, made by
tests/torch_make_gpa_tiles_reference.py); they add no kernel, and run the
main path's (OPTION_PATH printed, each nonzero):
56. globalPatchAllocation: a warm-up encode (cold seconds per frame) whose
    `pack_global` placements (every patch's position, orientation and
    chain, and the size) must equal the JAX package's digest, whichever
    branch the data-adaptive choice then takes; with all launch counters at
    0, a warm encode: seconds per frame, the stage split, the launches;
57. requires the branch taken, the stream's md5 and bytes and every frame's
    patches, atlas size and reconstruction to equal the JAX encoder's, the
    port's decoder to decode it to the reconstruction, and prints the AD
    substream's bytes beside the r3 fixture's (no GPA);
58. numMaxTilePerFrame=2: the same cold and warm encodes and checks as in
    steps 56-57 (no `pack_global`);
59. requires the tile rows, the tiles' height ratchets and each frame's
    patches per tile to equal the JAX encoder's, and each tile to parse alone
    (`read_atlas_substream(tile_filter=...)`) with every hash SEI good;
the three apps of the slice:
60. `apps/parser.py` on the fixture and on the GPA stream (each behind its
    8-byte GOF length): 8 ATLs, hash SEI OK; `apps/encode.py` and
    `apps/decode.py` on the first two bench frames on the card (own
    segmentation, metrics inline), then `apps/conformance.py` on their logs:
    "CONFORMANCE MATCH: 2 frames";
61. `apps/color_converter.py` rgb2ycc (4:4:4; 4:2:0 with filters 0 and 1)
    and ycc2rgb (nearest; filter 1) on the card over the encode's first T0
    image, each output equal to the same run with --device=cpu;
62. prints one JSON line describing the kernels (the vox11, D1-sum, EOM,
    PLR, RDO, fill, scalar, orientation, high-gradient, frame-batched and
    two-level entries as rows of their own, launches from steps 16, 24, 30,
    35, 39, 43, 48, 52 and 53), then the result line.

Any mismatch raises; the script exits non-zero and prints no result line
when CUDA is missing or the package is not beside it.  It imports nothing
of JAX and nothing of the vpcc_tpu package.
"""

from __future__ import annotations

import collections
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "vpcc_tpu_torch" / "data"
FIXTURE = DATA / "person_vox10_r3_gof8.vpcc"
DIGESTS = DATA / "person_vox10_r3_gof8_digests.json"
FRONT_DIGESTS = DATA / "person_vox10_front_digests.json"
FRONT_PARTITIONS = DATA / "person_vox10_front_partitions.npz"
ATTR_DIGESTS = DATA / "person_vox10_attr_digests.json"
RD_REFERENCE = DATA / "person_vox10_rd_reference.json"
VOX11_REFERENCE = DATA / "person_vox11_reference.json"
VOX11_PARTITIONS = DATA / "person_vox11_partitions.npz"
LOSSLESS_REFERENCE = DATA / "person_vox10_lossless_reference.json"
TOOLS_REFERENCE = DATA / "person_vox10_tools_reference.json"
ATTR_OPTIONS_REFERENCE = DATA / "person_vox10_attr_options_reference.json"
SEG_OPTIONS_REFERENCE = DATA / "person_vox10_seg_options_reference.json"
SEG_OPTIONS_PARTITIONS = DATA / "person_vox10_seg_options_partitions.npz"
GEO11_REFERENCE = DATA / "person_vox11_geo11_reference.json"
GPA_TILES_REFERENCE = DATA / "person_vox10_gpa_tiles_reference.json"
# the floor tests/test_torch_segmentation.py pins for the partition
# agreement with the JAX package, and the normals' tolerance (the kernel's
# acosf/cosf against PyTorch's on the card)
PARTITION_FLOOR = 0.998
NORMAL_ATOL = 1e-5
# the RD gate of the geometry encoder against the JAX encoder's fixture
RD_BYTES_TOL = 0.01
RD_PSNR_TOL_DB = 0.1
# the metrics of the fixture's decode against the JAX package's (float64
# sums here, float32 sums in XLA's order there), and kernel R's float64
# sums against its plain version's (another summation order)
METRICS_PSNR_TOL_DB = 1e-3
R_FLOAT_RTOL = 1e-9
# vox11: the D1 MSE against the JAX package's, in float32 ulps (the port
# sums the per-point squared distances in the reference's XLA order, which
# rounds beyond 2^24: ROADMAP F7)
VOX11_D1_MSE_ULPS = 0.0

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA-core float32 peak, used for int32 too

KERNEL_INFO = {
    "wavefront_decode32": ("vpcc_tpu_torch/csrc/wavefront_decode32.cu",
                           "vpcc_tpu/video/hevc.py:1150"),
    "half_pel_mc": ("vpcc_tpu_torch/csrc/half_pel_mc.cu",
                    "vpcc_tpu/video/hevc.py:418"),
    "generate_points": ("vpcc_tpu_torch/csrc/generate_points.cu",
                        "vpcc_tpu/ops/reconstruct.py:61"),
    "grid_smooth": ("vpcc_tpu_torch/csrc/grid_smooth.cu",
                    "vpcc_tpu/ops/smoothing.py:51"),
    "grid_knn": ("vpcc_tpu_torch/csrc/grid_knn.cu",
                 "vpcc_tpu/ops/neighbors.py:162"),
    # kernel E's other main-path calls (the row above: segmentation, k=16)
    "grid_knn.recolor_k8": ("vpcc_tpu_torch/csrc/grid_knn.cu", "vpcc_tpu/ops/neighbors.py:162"),
    "grid_knn.nearest_k1": ("vpcc_tpu_torch/csrc/grid_knn.cu", "vpcc_tpu/ops/neighbors.py:215"),
    "grid_knn.presmooth_k64": ("vpcc_tpu_torch/csrc/grid_knn.cu",
                               "vpcc_tpu/ops/neighbors.py:162"),
    "segment": ("vpcc_tpu_torch/csrc/segment.cu",
                "vpcc_tpu/ops/normals.py:72"),
    "cc_labels": ("vpcc_tpu_torch/csrc/cc_labels.cu",
                  "vpcc_tpu/ops/cc.py:31"),
    "coverage": ("vpcc_tpu_torch/csrc/coverage.cu",
                 "vpcc_tpu/ops/coverage.py:100"),
    "wavefront_encode32": ("vpcc_tpu_torch/csrc/wavefront_encode32.cu",
                           "vpcc_tpu/video/hevc.py:933"),
    "motion_search": ("vpcc_tpu_torch/csrc/motion_search.cu",
                      "vpcc_tpu/video/hevc.py:471"),
    "sao": ("vpcc_tpu_torch/csrc/sao.cu", "vpcc_tpu/video/hevc.py:216"),
    # kernel K's apply entry on the decode path
    "sao_apply": ("vpcc_tpu_torch/csrc/sao.cu", "vpcc_tpu/video/hevc.py:275"),
    "push_pull": ("vpcc_tpu_torch/csrc/push_pull.cu",
                  "vpcc_tpu/ops/padding.py:23"),
    "recolor": ("vpcc_tpu_torch/csrc/recolor.cu", "vpcc_tpu/ops/recolor.py:43"),
    "presmooth": ("vpcc_tpu_torch/csrc/presmooth.cu",
                  "vpcc_tpu/ops/smoothing.py:193"),
    "deblock": ("vpcc_tpu_torch/csrc/deblock.cu", "vpcc_tpu/video/hevc.py:161"),
    # kernel P, one row an entry (the scalar ones below)
    "attr_paint": ("vpcc_tpu_torch/csrc/attr_image.cu", "vpcc_tpu/pipeline.py:209"),
    "attr_group_dilate": ("vpcc_tpu_torch/csrc/attr_image.cu", "vpcc_tpu/ops/padding.py:149"),
    "attr_gather": ("vpcc_tpu_torch/csrc/attr_image.cu", "vpcc_tpu/pipeline.py:227"),
    "color_convert": ("vpcc_tpu_torch/csrc/color_convert.cu", "vpcc_tpu/video/hevc.py:1766"),
    # both directions, their D1 sums (vpcc_tpu/ops/metrics.py:87) included
    "metrics": ("vpcc_tpu_torch/csrc/metrics.cu", "vpcc_tpu/ops/metrics.py:57"),
    # the vox11 path's entries (11-bit geometry)
    "grid_knn_xyz": ("vpcc_tpu_torch/csrc/grid_knn.cu", "vpcc_tpu/ops/neighbors.py:104"),
    "cc_round_voxel": ("vpcc_tpu_torch/csrc/cc_labels.cu", "vpcc_tpu/ops/cc.py:225"),
    "recolor_blend": ("vpcc_tpu_torch/csrc/recolor.cu", "vpcc_tpu/ops/recolor.py:291"),
    # the lossless conditions' entries (EOM)
    "generate_points_eom": ("vpcc_tpu_torch/csrc/generate_points.cu",
                            "vpcc_tpu/ops/reconstruct.py:136"),
    "eom_colors": ("vpcc_tpu_torch/csrc/eom_colors.cu", "vpcc_tpu/pipeline.py:279"),
    # the reconstruction tools a stream signals (color smoothing, PBF, PLR)
    "color_smooth": ("vpcc_tpu_torch/csrc/color_smooth.cu", "vpcc_tpu/ops/smoothing.py:135"),
    "pbf": ("vpcc_tpu_torch/csrc/pbf.cu", "vpcc_tpu/ops/pbf.py:136"),
    "plr": ("vpcc_tpu_torch/csrc/plr.cu", "vpcc_tpu/ops/plr.py:102"),
    "plr_rdo": ("vpcc_tpu_torch/csrc/plr.cu", "vpcc_tpu/ops/plr.py:119"),
    "generate_points_plr": ("vpcc_tpu_torch/csrc/generate_points.cu",
                            "vpcc_tpu/ops/reconstruct.py:144"),
    # the attribute options (attributeBGFill 0 / 2, the reflectance attribute)
    "bg_dilate": ("vpcc_tpu_torch/csrc/bg_fill.cu", "vpcc_tpu/ops/padding.py:78"),
    "bg_harmonic": ("vpcc_tpu_torch/csrc/bg_fill.cu", "vpcc_tpu/ops/padding.py:109"),
    "attr_paint_scalar": ("vpcc_tpu_torch/csrc/attr_image.cu", "vpcc_tpu/pipeline.py:252"),
    "attr_gather_scalar": ("vpcc_tpu_torch/csrc/attr_image.cu", "vpcc_tpu/pipeline.py:270"),
    # the segmentation options (normalOrientation 2 / 4, highGradientSeparation)
    "orient_viewpoint": ("vpcc_tpu_torch/csrc/orient.cu", "vpcc_tpu/ops/normals.py:146"),
    "orient": ("vpcc_tpu_torch/csrc/orient.cu", "vpcc_tpu/ops/normals.py:158"),
    "high_gradient_aux": ("vpcc_tpu_torch/csrc/segment.cu", "vpcc_tpu/ops/segmentation.py:128"),
    "grid_knn_batch": ("vpcc_tpu_torch/csrc/grid_knn.cu", "vpcc_tpu/parallel/gof.py:124"),
    "recolor_exact_batch": ("vpcc_tpu_torch/csrc/recolor.cu", "vpcc_tpu/parallel/gof.py:116"),
    "recolor_blend_batch": ("vpcc_tpu_torch/csrc/recolor.cu", "vpcc_tpu/parallel/gof.py:140"),
    # the two-level (16/8) codec of planes above 10 bits
    "wavefront_encode16": ("vpcc_tpu_torch/csrc/wavefront_encode32.cu",
                           "vpcc_tpu/video/hevc.py:792"),
    "wavefront_decode16": ("vpcc_tpu_torch/csrc/wavefront_decode32.cu",
                           "vpcc_tpu/video/hevc.py:1263"),
}
DECODE_KERNELS = ("wavefront_decode32", "half_pel_mc", "generate_points", "grid_smooth")
FRONT_KERNELS = ("grid_knn", "segment", "cc_labels", "coverage")
# kernel G's launches a call (init, hook, finalize)
CC_LAUNCHES = 3
# kernel F's launches a segmentation chain (PCA, orientation, initial +
# refined partition)
CHAIN_LAUNCHES = 3
GEOMETRY_KERNELS = ("wavefront_encode32", "motion_search", "sao", "push_pull")
ATTR_ENTRIES = ("attr_paint", "attr_group_dilate", "attr_gather")
ENCODE_KERNELS = ("recolor", "presmooth", "deblock", *ATTR_ENTRIES, "color_convert")
# kernel E's calls on the encode path by k -> their rows (k=16: the front
# end's segmentation, the "grid_knn" row of the front-end phase; the
# JAX-partition-driven warm-up encode skips it, the main path's
# `segment_dispatch` runs it)
E_CALLS = {16: "grid_knn.segment_k16", 8: "grid_knn.recolor_k8", 1: "grid_knn.nearest_k1",
           64: "grid_knn.presmooth_k64"}
E_ENCODE_ROWS = tuple(v for k, v in E_CALLS.items() if k != 16)
METRICS_KERNELS = ("metrics",)
# rows of the vox11 phase -> the launch counter each reads on that path
VOX11_ROWS = {"grid_knn_xyz": "grid_knn_xyz", "cc_round_voxel": "cc_labels",
              "recolor_blend": "recolor"}
LOSSLESS_KERNELS = ("generate_points_eom", "eom_colors")
# the tools phase's configurations -> the kernels (launch counters) of each
TOOLS_KERNELS = {"cs": ("color_smooth",), "pbf": ("pbf",),
                 "plr": ("plr", "plr_rdo", "generate_points_plr")}
# the attribute-options phase's configurations -> its new entries (launch
# counters)
ATTR_OPTIONS_KERNELS = {"refl": ("attr_paint_scalar", "attr_gather_scalar"),
                        "refl_lossless": ("attr_paint_scalar", "attr_gather_scalar"),
                        "bgfill0": ("bg_dilate",), "bgfill2": ("bg_harmonic",)}
# the segmentation-options phase's configurations -> its new entries (launch
# counters)
SEG_OPTIONS_KERNELS = {"orient0": (), "orient2": ("orient_viewpoint",), "orient4": ("orient",),
                       "hgs": ("high_gradient_aux",), "roi": (), "tetris": ()}
# every kernel the whole encoder runs (kernel A decodes only)
ENCODER_PATH = ("half_pel_mc", "generate_points", "grid_smooth") + FRONT_KERNELS \
    + GEOMETRY_KERNELS + ENCODE_KERNELS
# the level-batched GOF path: the encoder's kernels with kernel M's
# single-frame entries replaced by the frame-batched ones of E and M
LEVEL_KERNELS = ("grid_knn_batch", "recolor_exact_batch", "recolor_blend_batch")
LEVEL_PATH = tuple(k for k in ENCODER_PATH if k != "recolor") + LEVEL_KERNELS
# the main-path kernels whose launches the GPA, tiles and apps phases print
# (E, F, G, H, I, M), each required nonzero
OPTION_PATH = ("grid_knn", "segment", "cc_labels", "coverage", "wavefront_encode32", "recolor")


def frame_digest(positions, colors) -> str:
    import numpy as np

    h = hashlib.md5()
    h.update(np.ascontiguousarray(positions, "<i4").tobytes())
    h.update(np.ascontiguousarray(colors, np.uint8).tobytes())
    return h.hexdigest()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def inter_pixels(s32, m32, s16, modes) -> int:
    """Samples of kernel A's planes whose decoded mode is inter: the only
    samples for which it reads the inter prediction plane `ref`."""
    from vpcc_tpu_torch.video.hevc_tables import MODE_INTER

    split32, split16 = s32 != 0, s16 != 0
    whole32 = (~split32 & (m32 == MODE_INTER)).sum() * 1024
    whole16 = (split32[..., None] & ~split16
               & (modes[..., 0] == MODE_INTER)).sum() * 256
    sub8 = ((split32[..., None] & split16)[..., None]
            & (modes == MODE_INTER)).sum() * 64
    return int(whole32 + whole16 + sub8)


def capture_key(name, args):
    """Which call of a kernel to keep: the largest; for kernel A, among the
    largest, the one that mixes inter- and intra-coded samples most evenly,
    so that its check against the plain version covers both branches."""
    size = sum(a.numel() for a in args if torch.is_tensor(a))
    if name == "wavefront_decode32":
        n_inter = inter_pixels(*args[1:3], *args[4:6])
        return (size, min(n_inter, args[1].numel() * 1024 - n_inter), n_inter)
    if name == "wavefront_decode16":
        n_inter = inter_pixels16(args[1], args[2])
        return (size, min(n_inter, args[1].numel() * 256 - n_inter), n_inter)
    if name == "wavefront_encode32":
        # among the largest, a motion-searched plane (CUs with an MV rate)
        return (size, int((args[5] > 0).sum()))
    if name == "wavefront_encode16":
        return (size, int((args[4] > 0).sum()))
    return (size,)


class Capture:
    """Keeps one call of each kernel wrapper during one decode (see
    `capture_key`), and counts the calls whose first tensor is not empty.
    `rename` maps a name to a function of (args, kw) that names the call
    (one kept call per name: kernel E per k); `keep=False` only counts."""

    def __init__(self, modules, rename=None, keep=True):
        self.modules = modules   # name -> (module, attr)
        self.rename = rename or {}
        self.keep = keep
        self.calls = {}
        self.counts = collections.Counter()
        self.saved = {}

    def __enter__(self):
        for name, (mod, attr) in self.modules.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn

            def spy(*args, _name=name, _fn=fn, **kw):
                name = self.rename[_name](args, kw) if _name in self.rename else _name
                first = next((a for a in args if torch.is_tensor(a)), None)
                if first is None or first.numel():
                    self.counts[name] += 1
                if self.keep:
                    key = capture_key(name, args)
                    if name not in self.calls or key > self.calls[name][0]:
                        self.calls[name] = (key, [
                            a.clone() if torch.is_tensor(a) else a for a in args
                        ], dict(kw))
                return _fn(*args, **kw)

            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.modules.items():
            setattr(mod, attr, self.saved[name])


def bounds(name, args, out, sweeps=None):
    """(bound_ms, bound_by) for one call: bytes of inputs read once and
    outputs written once over HBM bandwidth, against the integer/float
    operations these inputs need over the CUDA-core peak.  `sweeps`: kernel
    F's (orientation, refinement) sweeps this input needs."""
    import numpy as np

    if name == "wavefront_decode32":
        ref, s32, m32, c32, s16, modes, c16, dq, maxv, nby, nbx = args
        # a CU reads 2048 bytes of levels whichever tree it codes, and `ref`
        # only at its inter-coded samples
        byt = (nbytes(s32, m32, s16, modes, dq, maxv, out) + s32.numel() * 2048
               + inter_pixels(s32, m32, s16, modes) * ref.element_size())
        s32h = s32.cpu().numpy() != 0
        s16h = s16.cpu().numpy() != 0
        # two transform stages: 2n multiply-adds per sample of an n-block
        per_cu = np.where(s32h, np.where(s16h, 256 * 2 * 8, 256 * 2 * 16).sum(-1),
                          1024 * 2 * 32)
        ops = 2.0 * float(per_cu.sum())
    elif name == "wavefront_decode16":
        ref, split, modes, coeffs, dq, maxv, nby, nbx = args
        # a CU reads 512 bytes of levels whichever tree it codes, and `ref`
        # only at its inter-coded samples; two transform stages, 2n
        # multiply-adds per sample of an n-block
        byt = (nbytes(split, modes, dq, maxv, out) + split.numel() * 512
               + inter_pixels16(split, modes) * ref.element_size())
        sh = split.cpu().numpy() != 0
        ops = 2.0 * float(np.where(sh, 256 * 2 * 8, 256 * 2 * 16).sum())
    elif name == "half_pel_mc":
        ref, mv, maxv, bs = args[:4]
        byt = nbytes(ref, mv, maxv, out)
        P, H, W = ref.shape
        m = mv.cpu().numpy()
        fy, fx = (m[..., 0] & 1) != 0, (m[..., 1] & 1) != 0
        # MACs a pixel: 8 for one direction; HV, the horizontal pass over
        # the window's bs + 7 rows, then 8 down the clipped samples
        taps = np.where(fy & fx, 8 + 8 * (bs + 7) / bs, np.where(fy | fx, 8, 0))
        ops = 2.0 * float(taps.sum()) * bs * bs
    elif name == "generate_points":
        occ, g0, g1, btp, ptab = args[:5]
        byt = nbytes(occ, g0, g1, btp, ptab, *out)
        ops = 0.0
    elif name == "generate_points_eom":
        (occ, g0, g1, btp, ptab), kw = args[0][:5], args[1]
        byt = nbytes(occ, g0, g1, btp, ptab, kw["eom"], *out)
        ops = 0.0
    elif name == "eom_colors":
        # extract: the tags, the EOM rows' colors read and written; inject:
        # the tags, every color and the aux samples read, every color written
        (layer, _), (layer2, col2, aux) = args
        m = int((layer == 2).sum())
        byt = nbytes(layer) + 2 * 12 * m + nbytes(layer2, col2, aux, out[1])
        ops = 0.0
    elif name == "color_smooth":
        # points, colors, patch ids, flags read once, colors written once;
        # per row the luma (3 operations), 4 float and 5 integer sums, the
        # deviation and the tests (~15)
        byt = nbytes(*args[:4], out)
        ops = 15.0 * args[0].shape[0]
    elif name == "pbf":
        # the occupancy, D0, block map and patch table read once, the
        # filtered occupancy written once; per (border point, patch) pair
        # ~60 integer operations, per boundary pixel and pass the 45-sample
        # window at ~25 operations a sample (counted on this call's pass-0
        # boundary)
        (occ, geo0, btp, tbl, res), kw = args[0][:5], args[1]
        passes, fs = kw["passes"], kw["filter_size"]
        from vpcc_tpu_torch.ops import pbf as pbf_mod

        byt = nbytes(occ, geo0, btp, tbl, out)
        pid, occp = pbf_mod._pixel_patch(occ, btp, res)
        n4 = sum(pbf_mod._neighbour(occp, pid, dy, dx).to(torch.int64)
                 for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)))
        n_win = int((occp & (n4 > 0) & (n4 < 4)).sum())
        n_pts = pbf_mod.count_border_plain(occ, btp, res)
        win = (2 * fs + 1) * (2 * (fs >> 1) + 1)
        ops = 60.0 * n_pts * tbl.shape[0] + 25.0 * win * n_win * passes
    elif name == "plr":
        # the code plane: D0 and the block map read, the codes written; 24
        # neighbour deltas at ~4 operations each a pixel
        geo, bm, tbl = args[:3]
        byt = nbytes(geo, bm, tbl, out)
        ops = 100.0 * geo.numel()
    elif name == "plr_rdo":
        # the three planes, occupancy and block map read, the block and patch
        # modes written; per occupied pixel the deltas (~100) and per mode
        # ~40 operations
        g0d, g0t, g1t, occ, btp, tbl = args[:6]
        byt = nbytes(g0d, g0t, g1t, occ, btp, tbl, *out[:3])
        ops = float(int((occ != 0).sum())) * (100.0 + 40.0 * tbl.shape[0])
    elif name == "generate_points_plr":
        (occ, g0, g1, btp, ptab), kw = args[0][:5], args[1]
        byt = nbytes(occ, g0, g1, btp, ptab, kw["eom"], *out)
        ops = 0.0
    elif name == "bg_dilate":
        # the planes and occupancy read once, the filled planes written once;
        # per pixel the pass fills: 4 neighbour tests, and per plane 3 adds,
        # a division and a rounding (~10 operations)
        planes, occ = args[:2]
        byt = nbytes(planes, occ, out)
        ops = 10.0 * planes.shape[0] * int((occ == 0).sum())
    elif name == "bg_harmonic":
        # harmonic fill as fill_rgb calls it: the planes and occupancy read
        # once, the rounded planes written once; per level pixel and plane
        # the push (3 adds), the pull (a division) and 8 Jacobi steps of 3
        # adds and a multiply (~36 operations), over the pyramid (4/3 of the
        # finest level)
        planes, occ = args[:2]
        byt = nbytes(planes, occ, out)
        ops = 36.0 * planes.numel() * 4.0 / 3.0
    elif name == "smooth_fill":
        # the planes and occupancy read once, the filled planes written once;
        # the push-pull's pull (a division per level pixel) and 4 Jacobi
        # steps of 4 adds and a multiply per pixel and plane
        planes, occ = args[:2]
        byt = nbytes(planes, occ, out)
        ops = planes.numel() * (4.0 / 3.0 + 20.0)
    elif name == "transfer_reflectance":
        # the sources (positions, reflectance) and targets read once, the
        # target reflectance written once; the exact match's binary search
        # (~2 log2(Ns) operations) and the k=1 sweep's candidates (12
        # operations each, kernel E's count) per target
        from vpcc_tpu_torch.ops import neighbors

        src_pos, src_refl, tgt_pos = args[:3]
        grid = neighbors.build_grid(src_pos, 10)
        probes, cands = knn_work(grid, tgt_pos, 18)
        byt = nbytes(src_pos, src_refl, tgt_pos, out) + probes * 4
        ops = 12.0 * cands + 2.0 * tgt_pos.shape[0] * max(src_pos.shape[0], 2).bit_length()
    elif name in ("attr_paint_scalar", "attr_gather_scalar", "attr_paint", "attr_group_dilate",
                  "attr_gather"):
        # kernel P: each entry's inputs read once and outputs written once
        # (the winner planes of the paints are scratch, not counted)
        byt = nbytes(*(a for a in args if torch.is_tensor(a))) + nbytes(
            *(out if isinstance(out, tuple) else (out,)))
        ops = 0.0
    elif name == "orient_viewpoint":
        # normals and positions read once, the oriented normals written once;
        # per row 3 differences, the fma-chain dot, the sign, 3 products
        nrm, pos = args[:2]
        byt = nbytes(nrm, pos, out)
        ops = 10.0 * nrm.shape[0]
    elif name == "orient":
        # the flood: positions, normals, neighbour table, valid rows read once,
        # the oriented normals written once; per vote (an unsigned valid row in
        # a sweep, counted on this run's data by `flood_votes`) K dot products
        # of 3 multiply-adds, a sign product and an add (~8 operations each)
        pos, nrm, idx, valid = args[0], args[1], args[2], args[4]
        byt = nbytes(pos, nrm, idx, args[3], valid, out)
        ops = 8.0 * idx.shape[1] * flood_votes(*args)
    elif name == "high_gradient_aux":
        # normals, partitions, orientations read once, alt and weak written
        # once; per row and orientation a 3-term dot and a compare (~6)
        nrm, part, orients = args[:3]
        byt = nbytes(nrm, part, orients, *out)
        ops = 6.0 * nrm.shape[0] * orients.shape[0]
    elif name == "grid_smooth":
        pos, pid, bnd = args[:3]
        byt = nbytes(pos, pid, bnd, out)
        ops = 0.0
    elif name in ("grid_knn", "grid_knn_xyz"):
        grid, q, win = args[:3]
        probes, cands = knn_work(grid, q, win)
        # the starts entries the queries probe, the table (one packed word
        # or three int32 a row) and order, the queries; out idx and d2.  Per
        # candidate: (unpack,) 3 differences, squared distance, compare (12
        # integer operations packed, 9 unpacked)
        byt = probes * 4 + nbytes(grid.table, grid.order, q, *out)
        ops = (12.0 if grid.packed else 9.0) * cands
    elif name == "segment":
        pos, idx, valid = args[:3]
        V, K = idx.shape
        # the sweeps the chain ran (they end once one changes nothing)
        J = 6
        n_orient, n_refine = sweeps
        byt = nbytes(pos, idx, valid, *out)
        # per voxel: mean + deviations + 6 covariance FMAs over K, the
        # eigen solver (~120), the radial sign, the sweeps of K signed dot
        # products, the initial argmax, the sweeps of K votes over J plus J
        # scores
        per = (25 * K + 120 + 8 + n_orient * (9 * K + 3) + 6 * J
               + n_refine * (2 * J * K + 7 * J + 1))
        ops = float(per) * V
    elif name == "cc_labels":
        # `active` read and the labels written for every row; the edge table
        # and the partition only for the active rows (an inactive row's
        # group reads nothing else)
        idx, valid, part, active = args[:4]
        n_act = int(active.sum())
        byt = nbytes(active, out) + n_act * (idx.shape[1] * (idx.element_size()
                                                            + valid.element_size())
                                             + part.element_size())
        ops = 0.0
    elif name == "cc_round_voxel":
        # the voxel graph, partitions, point-to-voxel map and point mask read
        # once, the point labels written once
        byt = nbytes(*args[:5], out)
        ops = 0.0
    elif name == "coverage":
        res_packed, queries = args[:2]
        byt = nbytes(res_packed, queries, *out)
        ops = 0.0
    elif name == "wavefront_encode32":
        src, ref, w32, w16, w8, mvc = args[:6]
        nby, nbx = args[-2:]
        byt = nbytes(src, ref, w32, w16, w8, mvc, *out)
        # the two forward-DCT stages, n multiply-adds per coefficient each,
        # for the 36 modes of the 32x32 block, its four 16x16 quadrants and
        # their sixteen 8x8 blocks
        per_cu = 36 * 2 * (1024 * 32 + 4 * 256 * 16 + 16 * 64 * 8)
        ops = 2.0 * per_cu * src.shape[0] * nby * nbx
    elif name == "wavefront_encode16":
        src, ref, w16, w8, mvc = args[:5]
        nby, nbx = args[-2:]
        byt = nbytes(src, ref, w16, w8, mvc, *out)
        # the two forward-DCT stages for the 36 modes of the 16x16 block and
        # its four 8x8 blocks
        per_cu = 36 * 2 * (256 * 16 + 4 * 64 * 8)
        ops = 2.0 * per_cu * src.shape[0] * nby * nbx
    elif name == "motion_search":
        src, ref, lam, maxv, bs = args
        byt = nbytes(src, ref, lam, maxv, *out)
        # subtract, absolute value, add per sample for each of the 289
        # integer candidates (the half-pel refinement is ~2 % on top)
        ops = 3.0 * 17 * 17 * src.numel()
    elif name == "sao":
        src, rec, lam, wts, maxv = args
        byt = nbytes(src, rec, lam, wts, maxv, *out)
        # per sample: 4 classes x (2 differences, 2 signs, sum, compare,
        # 2 accumulations), then the apply's category and offset add
        ops = 40.0 * rec.numel()
    elif name == "sao_apply":
        rec, cls, off, maxv = args[:4]
        byt = nbytes(rec, cls, off, maxv, out)
        # per sample: the class's category (2 differences, 2 signs, a sum),
        # the offset's select, the add and the clip
        ops = 8.0 * rec.numel()
    elif name == "push_pull":
        img, occ = args
        byt = nbytes(img, occ, out)
        ops = 0.0
    elif name == "grid_knn_batch":
        # kernel E's bound summed over the frames of the batch
        grids, q, _k, bucket = args
        byt, ops = nbytes(grids.table, grids.order, q, *out), 0.0
        for b in range(q.shape[0]):
            probes, cands = knn_work(grids.frame(b), q[b], 3 * bucket)
            byt += probes * 4
            ops += 12.0 * cands
    elif name in ("recolor_exact_batch", "recolor_blend_batch"):
        byt = nbytes(*(a for a in args if torch.is_tensor(a))) + nbytes(
            *(out if isinstance(out, tuple) else (out,)))
        ops = 0.0
    elif name == "recolor":
        # the work of the three entries kernel M had before its two: their
        # inputs read once (the sources' colors, the targets, the sorted
        # keys, the k-NN rows, the two lists) and outputs written once (the
        # exact matches, the matched flags, the counts, the forward colors,
        # the merged colors), and the compaction's positions; the few flops
        # per row are far below the byte time
        src_pos, src_col, tgt, order, sk, idx, d2, tidx, td2 = args
        eidx, has, iidx, tq, uidx, sq, col = out
        byt = (nbytes(src_col, tgt, order, sk, idx, d2, tidx, td2, iidx, uidx, eidx, has, col,
                      tq, sq) + src_pos.shape[0] + 8 + 12 * iidx.shape[0])
        ops = 0.0
    elif name == "recolor_blend":
        # as before the blend entry took every row: the inputs, the lists of
        # every source and every target, the forward colors and the merged
        # colors, each once
        src_col, idx, d2, tidx, td2, eidx, has = args
        byt = nbytes(*args, out) + 4 * (src_col.shape[0] + eidx.shape[0]) + 12 * eidx.shape[0]
        ops = 0.0
    elif name == "presmooth":
        # the neighbour rows and the query rows read; of the colors only the
        # distinct rows that the valid slots name and the queries' own rows
        # (the kernel gathers no other); the queries' new colors written
        colors, nidx, nd2, bidx, _out, radius2 = args[:6]
        valid = (nd2 < 0x7FFFFFF0) & (nd2.to(torch.float32) <= radius2)
        rows = torch.unique(torch.cat([nidx[valid].long(), bidx])).numel()
        byt = (rows * colors.stride(0) * colors.element_size() + nbytes(nidx, nd2, bidx)
               + 12 * bidx.numel() + 65 * 65 * 4)
        # per slot: gate, luma (2 FMAs + 1 mul), histogram add and read,
        # entropy term, centroid adds (~12 operations)
        ops = 12.0 * nidx.numel()
    elif name == "color_convert":
        # both entries: attr (an image, a batch, or a list of images) ->
        # (y, chroma) and (y, cb, cr) -> rgb; per pixel ~15 float
        # operations each way (products, FMAs, rounding)
        planes_args, rgb_args = args
        attr = planes_args[0]
        byt = nbytes(*(attr if isinstance(attr, (list, tuple)) else (attr,)), *out[:2]) \
            + nbytes(*rgb_args, out[2])
        ops = 15.0 * (out[0].numel() + rgb_args[0].numel())
    elif name == "metrics":
        # the fused unit, both directions: every input read once (each
        # cloud's positions, colors and normals are the A side of one
        # direction and the B side of the other; nearest index and d2 of
        # each), the result written; per A row ~50 float operations (error,
        # projection, two BT.709 conversions, squares, float64 sums) and
        # the D1 sum's add
        seen = {t.data_ptr(): t for a in args for t in a[:7] if t is not None}
        byt = nbytes(*seen.values()) + nbytes(out)
        ops = 51.0 * sum(a[7] for a in args)
    else:  # deblock
        rec, qps, maxv = args
        byt = nbytes(rec, qps, maxv, out)
        # per sample next to an edge (a quarter of them, both directions):
        # the delta, its gate and the clamped update (~12 operations)
        ops = 12.0 * rec.numel() / 2
    t_bytes = byt / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flood_votes(pos, nrm, idx, valid_k, valid, pad_rows=False) -> int:
    """Votes the spanning-tree flood needs on these inputs (the
    data-dependent part of kernel X's flood bound), from the plain version's
    steps: in each sweep, the unsigned valid rows with a valid neighbour
    signed in the sweep before (the seed before sweep 1), the only rows
    whose vote can differ from the sweep before."""
    from vpcc_tpu_torch.ops import normals

    seed, s = normals.flood_seed(pos, nrm, valid, pad_rows)
    sign = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
    new = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    if seed >= 0:
        sign[seed] = s
        new[seed] = True
    votes = 0
    for _ in range(normals.FLOOD_MAX_SWEEPS):
        unsigned = (sign == 0) & valid
        cand = unsigned & (new[idx.long()] & valid_k).any(1)
        n = int(cand.sum())
        if n == 0:
            break
        votes += n
        vote = normals.flood_votes_plain(nrm, idx, valid_k, sign)
        new = cand & (vote.abs() > normals.FLOOD_VOTE_MIN)
        if not bool(new.any()):
            break
        sign = torch.where(new, torch.where(vote < 0, -1.0, 1.0), sign)
    return votes


def knn_work(grid, q, win):
    """(distinct starts entries probed, candidates scanned) of a k-NN call:
    the data-dependent part of kernel E's bound."""
    g = grid.cells_per_axis
    qc = (q >> grid.cell_bits).long()
    off = torch.tensor([[dx, dy] for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       device=q.device)
    ncx = qc[:, 0:1] + off[None, :, 0]
    ncy = qc[:, 1:2] + off[None, :, 1]
    ok = ((ncx >= 0) & (ncx < g) & (ncy >= 0) & (ncy < g)
          & (qc[:, 2:3] >= 0) & (qc[:, 2:3] < g))
    base = (ncx * g + ncy) * g
    clo = base + (qc[:, 2:3] - 1).clamp(min=0)
    chi1 = base + (qc[:, 2:3] + 1).clamp(max=g - 1) + 1
    starts = grid.starts.long()
    cnt = (starts[chi1.clamp(0, g ** 3)] - starts[clo.clamp(0, g ** 3)]).clamp(0, win)
    cands = int((cnt * ok).sum())
    probes = int(torch.unique(torch.cat([clo[ok], chi1[ok]])).numel())
    return probes, cands


def graph_ms(fn, reps: int = 50) -> float:
    """Device milliseconds of one call of fn: captured once into a CUDA
    graph and replayed between CUDA events, without the caller's Python and
    launch overhead (for wrappers whose calls are host-bound)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, reps)


def timed(fn):
    """(fn(), its milliseconds by CUDA events) for one call."""
    out = []
    ms = time_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def launches_and_syncs(dev, fn, counter: str):
    """(launches of `counter` one call of fn adds, the host synchronisations
    torch reports for it under sync debug mode "warn")."""
    import warnings

    torch.cuda.synchronize()
    before = dev.LAUNCHES[counter]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (dev.LAUNCHES[counter] - before,
            sum("called a synchronizing" in str(w.message) for w in seen))


# a call's most launches and host reads of kernel W's dilation (seed, level
# walk, finish; the pass count) and kernel X's flood (prep, sweep walk,
# finish; the sweep count)
WALK_LIMITS = {"bg_dilate": (3, 1), "orient": (3, 1)}


def frontier_cases(dev, which: str) -> None:
    """Kernel W's dilation ("W") or kernel X's flood ("X") on the crafted
    cases of tests/torch_frontier.py (the torus wrap, sides of 1 and 2, the
    cap, empty and full occupancy; a vote that cancels and is signed later,
    a disconnected component, pad_rows, V = 0, a random graph), each against
    its plain version, with the launches and host reads of every call."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_frontier import DILATE_CASES, FLOOD_CASES, dilate_case, flood_case
    from vpcc_tpu_torch.ops import normals, padding

    d = torch.device("cuda")
    seen = []
    if which == "W":
        for case in DILATE_CASES:
            planes, occ, max_iters = dilate_case(case)
            tp, to = torch.as_tensor(planes, device=d), torch.as_tensor(occ, device=d)
            x_p, n_p = padding.dilate_fill_plain(tp, to, max_iters)
            x_k, n_k = padding.dilate_fill(tp, to, max_iters)
            r_k, n_r = padding.dilate_fill(tp, to, max_iters, rounded=True)
            err = max(max_abs_err(x_k, x_p), max_abs_err(r_k, padding.round_clip_plain(x_p)))
            calls = launches_and_syncs(dev, lambda: padding.dilate_fill(
                tp, to, max_iters, rounded=True), "bg_dilate")
            if err != 0 or n_k != n_p or n_r != n_p or calls != WALK_LIMITS["bg_dilate"]:
                raise AssertionError(f"bg_dilate {case}: max abs err {err}, passes {n_k} / "
                                     f"{n_r} vs plain {n_p}, launches and host reads {calls}")
            seen.append(f"{case} {n_k}")
        print(f"bg_dilate crafted cases: exact, passes as the plain version's, 3 launches and "
              f"1 host read a call: " + ", ".join(seen))
        return
    for case in FLOOD_CASES:
        pos, nrm, idx, val, valid, pad = flood_case(case)
        t = [torch.as_tensor(np.ascontiguousarray(a), device=d)
             for a in (pos, nrm, idx, val, valid)]
        want, sweeps = normals.orient_normals_spanning_tree_plain(*t, pad_rows=pad)
        got = normals.orient_normals_spanning_tree(*t, pad_rows=pad)
        err = max_abs_err(got, want)
        calls = launches_and_syncs(
            dev, lambda: normals.orient_normals_spanning_tree(*t, pad_rows=pad), "orient")
        limit = WALK_LIMITS["orient"] if len(pos) else (0, 0)
        if err != 0 or normals.last_flood_sweeps != sweeps or calls != limit:
            raise AssertionError(f"orient {case}: max abs err {err}, sweeps "
                                 f"{normals.last_flood_sweeps} vs plain {sweeps}, launches "
                                 f"and host reads {calls}")
        seen.append(f"{case} {sweeps}")
    print(f"orient crafted cases: exact, sweeps as the plain version's, 3 launches and 1 "
          f"host read a call (none for V = 0): " + ", ".join(seen))


# a call's most launches and host reads of kernel W's harmonic entry on
# 1280 x 1280 planes (push, coarse levels, four tile levels) and of kernel
# V's RDO (blocks, patches; the packed result)
HARMONIC_LIMITS = (6, 0)
RDO_LIMITS = (2, 1)


def harmonic_cases(dev) -> None:
    """Kernel W's harmonic entry on the crafted cases of
    tests/torch_fill_rdo_cases.py (sides off the tile grid, a corner pixel,
    empty and full, values of 2^0..2^30, 1, 3 and 6 planes, 48 x 80, 6 x 10,
    an odd side, 1024 x 1024, coarsest levels above 80 x 80 pixels): the
    float and rounded planes and the smoothed push-pull against the plain
    versions, also with more steps than a tile launch runs (11 a level, 10
    after the push-pull), the push's sums past 2^24 counted as the plain
    push counts them, the launches (as `harmonic_launches` plans them) and
    host reads of every call."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_fill_rdo_cases import HARMONIC_CASES, harmonic_case, harmonic_launches
    from vpcc_tpu_torch.ops import padding

    d = torch.device("cuda")
    seen = []
    for case in HARMONIC_CASES:
        planes, occ = (torch.as_tensor(a, device=d) for a in harmonic_case(case))
        padding.reset_inexact()
        x_p = padding.harmonic_fill_plain(planes, occ)
        n_p = padding.inexact_blocks()
        padding.reset_inexact()
        x_k = padding.harmonic_fill(planes, occ)
        n_k = padding.inexact_blocks()
        err = max(max_abs_err(x_k, x_p),
                  max_abs_err(padding.harmonic_fill(planes, occ, rounded=True),
                              padding.round_clip_plain(x_p)),
                  max_abs_err(padding.smooth_fill(planes, occ),
                              padding.smooth_fill_plain(planes, occ)),
                  max_abs_err(padding.harmonic_fill(planes, occ, 11),
                              padding.harmonic_fill_plain(planes, occ, 11)),
                  max_abs_err(padding.smooth_fill(planes, occ, 10),
                              padding.smooth_fill_plain(planes, occ, 10)))
        calls = launches_and_syncs(dev, lambda: padding.harmonic_fill(planes, occ, rounded=True),
                                   "bg_harmonic")
        more = launches_and_syncs(dev, lambda: padding.harmonic_fill(planes, occ, 11),
                                  "bg_harmonic")
        want = (harmonic_launches(*occ.shape), 0), (harmonic_launches(*occ.shape, 11, 11), 0)
        if err != 0 or n_k != n_p or (calls, more) != want:
            raise AssertionError(f"bg_harmonic {case}: max abs err {err}, sums past 2^24 {n_k} "
                                 f"vs plain {n_p}, launches and host reads {calls}, with 11 "
                                 f"steps {more}, planned {want}")
        seen.append(f"{case} {tuple(planes.shape)} {calls[0]} ({more[0]})")
    print("bg_harmonic crafted cases: exact (float, rounded, smoothed push-pull; 8 and 11 "
          "steps), sums past 2^24 counted as the plain push's, no host read; case, planes, "
          "launches (with 11 steps): " + ", ".join(seen))


def rdo_cases(dev) -> None:
    """Kernel V's RDO on the crafted cases of tests/torch_fill_rdo_cases.py
    (a patch across many scan chunks, an index with no block, patch 0's
    blocks, a patch of exactly block_threshold blocks, 1 and 16 modes,
    sums reaching 2^24): the four results against the plain version's, the
    launches and host reads of every call."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_fill_rdo_cases import RDO_CASES, rdo_case
    from vpcc_tpu_torch.ops import plr

    d = torch.device("cuda")
    seen = []
    for case in RDO_CASES:
        *arrays, res, thr, p_max = rdo_case(case)
        args = [torch.as_tensor(np.ascontiguousarray(a), device=d) for a in arrays]
        got = plr.rdo(*args, res, thr, p_max)
        want = plr.rdo_plain(*args, res, thr, p_max)
        err = max_abs_err(tuple(got[:3]), tuple(want[:3]))
        calls = launches_and_syncs(dev, lambda: plr.rdo(*args, res, thr, p_max), "plr_rdo")
        if err != 0 or got.inexact != want.inexact or calls != RDO_LIMITS:
            raise AssertionError(f"plr_rdo {case}: max abs err {err}, inexact {got.inexact} vs "
                                 f"plain {want.inexact}, launches and host reads {calls}")
        seen.append(f"{case} (M {arrays[5].shape[0]}, inexact {got.inexact})")
    print("plr_rdo crafted cases: exact, inexact counts as the plain version's, 2 launches and "
          "1 host read a call: " + ", ".join(seen))


def time_turns(kern, plain, reps_k=20, reps_p=3):
    """(kernel ms, plain ms) means of two runs each, in turns (plain,
    kernel, kernel, plain)."""
    p1 = time_ms(plain, reps_p)
    k1 = time_ms(kern, reps_k)
    k2 = time_ms(kern, reps_k)
    p2 = time_ms(plain, reps_p)
    return (k1, k2), (p1, p2)


def color_wrappers(hevc) -> dict:
    """Capture names of kernel Q's two entries."""
    return {"color_to_planes": (hevc, "rgb_to_planes"),
            "color_to_rgb": (hevc, "_int_planes_to_rgb")}


def color_entries(hevc, planes_args, rgb_args, plain: bool):
    """Kernel Q's two entries (or their plain versions) on their captured
    inputs: (y, chroma, rgb)."""
    if plain:
        return (*hevc.rgb_to_planes_plain(*planes_args),
                hevc.int_planes_to_rgb_plain(*rgb_args))
    return (*hevc.rgb_to_planes(*planes_args), hevc._int_planes_to_rgb(*rgb_args))


def no_sync_launches(dev, name: str, fn) -> int:
    """Runs fn() once under torch.cuda.set_sync_debug_mode("error"), so that
    a host wait raises, and returns the launches it added to
    dev.LAUNCHES[name]."""
    torch.cuda.synchronize()
    before = dev.LAUNCHES[name]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dev.LAUNCHES[name] - before


def color_check(dev, hevc, cap, where: str) -> dict:
    """Kernel Q == its plain version, exactly, on the largest call of each
    entry that `cap` kept (the chroma tensor == the plain cb and cr,
    stacked); each entry once under sync debug mode "error" in one launch;
    call and device times of each entry and of the pair; times the pair and
    its plain version in turns.  Returns the kernel row."""
    p_args = cap.calls["color_to_planes"][1]
    r_args = cap.calls["color_to_rgb"][1]
    kern = lambda: color_entries(hevc, p_args, r_args, plain=False)
    plain = lambda: color_entries(hevc, p_args, r_args, plain=True)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(tuple(out_k), tuple(out_p))
    if err != 0:
        raise AssertionError(f"color_convert ({where}): kernel differs from its plain version "
                             f"(max abs err {err})")
    to_planes = lambda: hevc.rgb_to_planes(*p_args)
    to_rgb = lambda: hevc._int_planes_to_rgb(*r_args)
    launches = [no_sync_launches(dev, "color_convert", f) for f in (to_planes, to_rgb)]
    if launches != [1, 1]:
        raise AssertionError(f"color_convert ({where}): {launches} launches a call, expected 1")
    (k1, k2), (p1, p2) = time_turns(kern, plain)
    b_ms, b_by = bounds("color_convert", (p_args, r_args), out_k)
    times = ", ".join(f"{what} call {time_ms(f, 20):.4f} device {graph_ms(f):.4f} ms"
                      for what, f in (("to planes", to_planes), ("to RGB", to_rgb),
                                      ("pair", kern)))
    shapes = [(tuple(p_args[0].shape), str(p_args[0].dtype)), tuple(r_args[0].shape)]
    print(f"color_convert ({where}): exact (max abs err {err}; chroma tensor = plain cb, cr "
          f"stacked); kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); {times} (CUDA graph replay); one launch an entry call, no "
          f"host synchronisation (sync debug mode \"error\"); both entries, inputs {shapes}")
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def color_batch_check(hevc, calls, where: str) -> None:
    """Kernel Q's `rgb_to_planes` against its plain version on every call in
    `calls` (batches of images included), bit for bit."""
    if not calls:
        raise AssertionError(f"rgb_to_planes: no call captured on {where}")
    batches = collections.Counter()
    for i, a in enumerate(calls):
        got, want = hevc.rgb_to_planes(*a), hevc.rgb_to_planes_plain(*a)
        if max_abs_err(tuple(got), tuple(want)) != 0:
            raise AssertionError(f"rgb_to_planes call {i} on {where}: kernel differs from its "
                                 "plain version")
        src = a[0][0] if isinstance(a[0], (list, tuple)) else a[0]
        batches[(tuple(got[0].shape), str(src.dtype))] += 1
    print(f"rgb_to_planes: all {len(calls)} captured calls of {where} exact (y and the chroma "
          "tensor); (y shape, RGB type) x calls: "
          + ", ".join(f"{k} x {v}" for k, v in batches.items()))


def deblock_all_check(dev, hevc, calls, where: str, maxval=None) -> None:
    """Kernel O against its plain version on every call in `calls`, bit for
    bit; the largest once under sync debug mode "error" in one launch, with
    its call and device times.  `maxval`: a value some call must carry."""
    if not calls:
        raise AssertionError(f"deblock: no call captured on {where}")
    for i, a in enumerate(calls):
        if not torch.equal(hevc.deblock_planes(*a), hevc.deblock_planes_plain(*a)):
            raise AssertionError(f"deblock call {i} on {where} ({tuple(a[0].shape)}): kernel "
                                 "differs from its plain version")
    maxvals = sorted({int(v) for a in calls for v in a[2].tolist()})
    if maxval is not None and maxval not in maxvals:
        raise AssertionError(f"deblock on {where}: no call on maxval {maxval} planes "
                             f"({maxvals})")
    big = max(calls, key=lambda a: a[0].numel())
    fn = lambda: hevc.deblock_planes(*big)
    n = no_sync_launches(dev, "deblock", fn)
    if n != 1:
        raise AssertionError(f"deblock on {where}: {n} launches a call, expected 1")
    shapes = collections.Counter(tuple(a[0].shape) for a in calls)
    print(f"deblock: all {len(calls)} captured calls of {where} exact; maxvals {maxvals}; "
          f"planes x calls: " + ", ".join(f"{k} x {v}" for k, v in shapes.items())
          + f"; the largest: one launch, no host synchronisation (sync debug mode \"error\"), "
          f"call {time_ms(fn, 20):.4f} ms, device {graph_ms(fn):.4f} ms (CUDA graph replay)")


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of fn: the time of its CUDA kernels
    under torch.profiler over `reps` calls (for wrappers that a CUDA graph
    cannot hold: the cooperative launches of kernels H, M and D, the reads
    of C and M; copies are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0 and e.count and not e.key.startswith(("Memcpy", "Memset")):
            # a kernel's mean over the launches the trace kept, times its
            # launches a call (the trace can miss some of a cooperative
            # kernel's records)
            us += t / e.count * max(1, round(e.count / reps))
    return us / 1e3


def host_syncs(fn) -> int:
    """The host synchronisations torch reports for one call of fn (sync
    debug mode "warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in seen)


def coverage_all_check(dev, coverage, calls) -> None:
    """Kernel H against its plain version on every captured call (both
    flags bit for bit), one launch a call; the largest frame's first call
    once under sync debug mode "error"; per round of that frame its call
    time, device time (`device_ms`) and bound.  `calls`: (a key of the
    query tensor, the arguments) in call order, a frame's rounds on one
    query tensor."""
    for i, (_, a) in enumerate(calls):
        torch.cuda.synchronize()
        before = dev.LAUNCHES["coverage"]
        got = coverage.covered_radius_slab(*a)
        launches = dev.LAUNCHES["coverage"] - before
        want = coverage.covered_radius_slab_plain(*a)
        if launches != 1 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"coverage call {i} (R {a[0].shape[0]}, N {a[1].shape[0]}): "
                                 f"{launches} launches, kernel differs from its plain version: "
                                 f"{not all(torch.equal(g, w) for g, w in zip(got, want))}")
    frames = []
    for key, a in calls:
        if not frames or frames[-1][0] != key:
            frames.append((key, []))
        frames[-1][1].append(a)
    rounds = max((f for _, f in frames), key=lambda f: f[0][1].shape[0] + f[0][0].shape[0])
    fn = lambda: coverage.covered_radius_slab(*rounds[0])
    if no_sync_launches(dev, "coverage", fn) != 1:
        raise AssertionError("coverage: expected one launch a call")
    print(f"coverage: all {len(calls)} captured calls of the warm-up exact (both flags), one "
          f"launch a call, rounds a frame {[len(f) for _, f in frames]}; the largest frame's "
          "round 0: no host synchronisation (sync debug mode \"error\")")
    for r, a in enumerate(rounds):
        fn = lambda a=a: coverage.covered_radius_slab(*a)
        b_ms, b_by = bounds("coverage", a, fn())
        print(f"coverage, round {r} of the largest frame (R {a[0].shape[0]}, N "
              f"{a[1].shape[0]}, slab ({a[2]}, {a[6]})): call {time_ms(fn, 20):.4f} ms, device "
              f"{device_ms(fn):.4f} ms (torch.profiler), bound {b_ms:.4f} ms ({b_by})")


def gp_counter(kw) -> str:
    """The launch counter of a kernel C call: the two-layer entry's, or its
    EOM or PLR entry's."""
    return "generate_points" if kw.get("eom") is None else kw.get("entry", "generate_points_eom")


def gp_all_check(dev, reconstruct, log, where: str) -> None:
    """Kernel C against its plain version on every call `log` (a CallLog)
    kept, all five fields bit for bit, two launches a call (one where no
    pixel has a point); the largest call with exactly one host
    synchronisation (sync debug mode "warn"), its call and device times."""
    calls = list(zip(log.calls, log.kws))
    if not calls:
        raise AssertionError(f"generate_points: no call captured on {where}")
    shapes = collections.Counter()
    for i, (a, kw) in enumerate(calls):
        counter = gp_counter(kw)
        torch.cuda.synchronize()
        before = dev.LAUNCHES[counter]
        got = reconstruct.generate_points(*a, **kw)
        launches = dev.LAUNCHES[counter] - before
        want = reconstruct.generate_points_plain(
            *a, **{k: v for k, v in kw.items() if k != "entry"})
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        if not same or launches != (2 if got.pos.shape[0] else 1):
            raise AssertionError(f"generate_points call {i} on {where} ({tuple(a[0].shape)}, "
                                 f"{counter}): exact {same}, {launches} launches")
        shapes[(tuple(a[0].shape), counter)] += 1
    a, kw = max(calls, key=lambda c: c[0][0].numel())
    fn = lambda: reconstruct.generate_points(*a, **kw)
    syncs = host_syncs(fn)
    if syncs != 1:
        raise AssertionError(f"generate_points on {where}: {syncs} host synchronisations a "
                             "call, expected 1")
    print(f"generate_points: all {len(calls)} captured calls of {where} exact (pos, pix, "
          "layer, pid, bnd), two launches a call; (shape, entry) x calls: "
          + ", ".join(f"{k} x {v}" for k, v in shapes.items())
          + f"; the largest: one host synchronisation (the row count), call "
          f"{time_ms(fn, 20):.4f} ms, device {device_ms(fn):.4f} ms (torch.profiler)")


def decode_phase(dev):
    """Steps 3-5: kernels A-D and Q on the decode path.  Returns (rows,
    launches, the decoded frames)."""
    import numpy as np

    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.ops import reconstruct, smoothing
    from vpcc_tpu_torch.video import hevc

    stream = FIXTURE.read_bytes()
    digests = json.loads(DIGESTS.read_text())
    n_frames = len(digests["frames"])

    # 3. warm-up decode, capturing each kernel's main-path input
    wrappers = {
        "wavefront_decode32": (hevc, "wavefront_decode32"),
        "half_pel_mc": (hevc, "half_pel_mc"),
        "generate_points": (reconstruct, "generate_points"),
        "grid_smooth": (smoothing, "grid_smooth"),
        "sao_apply": (hevc, "sao_apply"),
    }
    plains = {
        "wavefront_decode32": hevc.wavefront_decode32_plain,
        "half_pel_mc": hevc.half_pel_mc_plain,
        "generate_points": reconstruct.generate_points_plain,
        "grid_smooth": smoothing.smooth_point_cloud_grid_plain,
        "sao_apply": hevc.sao_apply_plain,
    }
    t0 = time.perf_counter()
    with Capture({**wrappers, **color_wrappers(hevc)}) as cap, \
            CallLog(hevc, "deblock_planes") as db_log, \
            CallLog(reconstruct, "generate_points") as gp_log, \
            CallLog(smoothing, "grid_smooth") as gs_log, \
            CallLog(hevc, "half_pel_mc") as b_log:
        Decoder(device="cuda").decode(stream)
        torch.cuda.synchronize()
    print(f"cold decode: {time.perf_counter() - t0:.2f}s for {n_frames} frames")
    print_calls(cap.counts, "the decode path", n_frames)
    missing = sorted((set(wrappers) | set(color_wrappers(hevc))) - set(cap.calls))
    if missing:
        raise AssertionError(f"kernels never called on the decode path: {missing}")
    _, n_mixed, n_inter = cap.calls["wavefront_decode32"][0]
    if n_mixed == 0:
        raise AssertionError("wavefront_decode32: no call mixes inter and intra CUs")
    print(f"wavefront_decode32 check input: {n_inter} inter-coded samples of "
          f"{cap.calls['wavefront_decode32'][1][1].numel() * 1024}")

    # 4. kernel == plain version on the card, and times in turns
    rows = {}
    for name, (mod, attr) in wrappers.items():
        _, args, kw = cap.calls[name]
        kern = getattr(mod, attr)
        plain = plains[name]
        out_k = kern(*args, **kw)
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(tuple(out_k) if isinstance(out_k, tuple) else out_k,
                          tuple(out_p) if isinstance(out_p, tuple) else out_p)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        (k1, k2), (p1, p2) = time_turns(lambda: kern(*args, **kw),
                                        lambda: plain(*args, **kw))
        b_ms, b_by = bounds(name, args, out_k)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        if name == "sao_apply":   # a short call: its device time apart
            shapes.append(f"device {graph_ms(lambda: kern(*args, **kw)):.4f} ms a call "
                          "(CUDA graph replay)")
        if name in ("generate_points", "grid_smooth"):
            shapes.append(f"device {device_ms(lambda: kern(*args, **kw)):.4f} ms a call "
                          "(torch.profiler)")
        print(f"{name}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"inputs {shapes}")
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    color_check(dev, hevc, cap, "decode")
    deblock_all_check(dev, hevc, db_log.calls, "the decode path")
    gp_all_check(dev, reconstruct, gp_log, "the fixture decode")
    gs_all_check(dev, smoothing, gs_log, "the fixture decode")
    b_all_check(dev, hevc, b_log.calls, "the fixture decode", bs=32)
    del db_log, gp_log, gs_log, b_log

    # 5. the main path, counted and timed
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture({**{k: wrappers[k] for k in ("wavefront_decode32", "sao_apply",
                                               "generate_points", "grid_smooth",
                                               "half_pel_mc")},
                  **oq_wrappers(hevc)}, keep=False) as calls:
        frames = Decoder(device="cuda").decode(stream)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dev.LAUNCHES)
    m_d_calls(launches, calls.counts, "the decode path", n_frames)
    one_a_call("wavefront_decode32", launches, calls.counts, "the decode path")
    one_a_call("half_pel_mc", launches, calls.counts, "the decode path")
    print(f"generate_points on the decode path: {launches['generate_points']} launches for "
          f"{calls.counts['generate_points']} calls")
    if launches["generate_points"] != 2 * calls.counts["generate_points"]:
        raise AssertionError("generate_points: expected two launches a call on the decode path")
    one_a_call("sao", launches, {"sao": calls.counts["sao_apply"]}, "the decode path")
    oq_one_a_call(launches, calls.counts, "the decode path")
    if len(frames) != n_frames:
        raise AssertionError(f"decoded {len(frames)} frames, expected {n_frames}")
    for i, (pc, ref) in enumerate(zip(frames, digests["frames"])):
        got = frame_digest(pc.positions, pc.colors)
        if pc.point_count != ref["points"] or got != ref["md5"]:
            raise AssertionError(
                f"frame {i}: {pc.point_count} points md5 {got}, JAX decoder "
                f"recorded {ref['points']} points md5 {ref['md5']}"
            )
        if not np.all(np.isfinite(pc.positions)):
            raise AssertionError(f"frame {i}: non-finite positions")
    print(f"warm decode: {dt:.3f}s for {n_frames} frames = {dt / n_frames:.4f} "
          f"s/frame; all {n_frames} frames match the JAX digests "
          f"(points {[pc.point_count for pc in frames]})")
    print(f"launches on the decode path: {launches}")
    idle = [k for k in DECODE_KERNELS + ("sao", "deblock", "attr_gather", "color_convert")
            if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the decode path: {idle}")
    return rows, launches, frames


def print_calls(counts, where: str, n: int) -> None:
    """Calls a frame of each captured wrapper on a path (the unit whose time
    a row gives; launches a frame are printed apart)."""
    print(f"calls a frame on {where}: "
          + ", ".join(f"{k} {v / n:g}" for k, v in sorted(counts.items())))


def one_a_call(name, launches, counts, where: str) -> None:
    """Kernels A and K launch once a call: the launches counted on a path
    equal the calls of the wrapper on non-empty stacks."""
    print(f"{name} on {where}: {launches.get(name, 0)} launches for {counts[name]} calls")
    if launches.get(name, 0) != counts[name]:
        raise AssertionError(f"{name}: {launches.get(name, 0)} launches for {counts[name]} "
                             f"calls on {where}, expected one a call")


def oq_wrappers(hevc) -> dict:
    """Capture names of kernel O's wrapper and kernel Q's two entries (for
    counting their calls on a path)."""
    return {"deblock": (hevc, "deblock_planes"), **color_wrappers(hevc)}


def oq_one_a_call(launches, counts, where: str) -> None:
    """Kernel O and each entry of kernel Q launch once a call."""
    one_a_call("deblock", launches, counts, where)
    one_a_call("color_convert", launches, {"color_convert": counts["color_to_planes"]
                                           + counts["color_to_rgb"]}, where)


def front_digests(fr):
    """The digests the JAX front-end reference data holds, for one frame."""
    import numpy as np

    from vpcc_tpu_torch.utils.checksum import array_md5, patches_md5

    return dict(
        patches=len(fr.patches), patches_md5=patches_md5(fr.patches),
        width=fr.width, height=fr.height,
        occupancy_md5=array_md5(fr.frame.occupancy, np.uint8),
        geometry0_md5=array_md5(fr.frame.geometry0, "<u2"),
        geometry1_md5=array_md5(fr.frame.geometry1, "<u2"),
        occ_video_md5=array_md5(fr.occ_video, np.uint8),
        block_to_patch_md5=array_md5(fr.block_to_patch, "<i4"),
    )


def chain_consts(segmentation, pos):
    """The encoder's constant inputs of kernel F's chain on the device:
    (valid rows, orientations, weights)."""
    return (torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device),
            torch.as_tensor(segmentation.ORIENTATIONS6, device=pos.device),
            torch.ones(6, dtype=torch.float32, device=pos.device))


def segment_chain(normals, segmentation, pos, idx, valid, consts, plain: bool):
    """Kernel F's stages on one voxel graph, as the encoder runs them (PCA,
    orientation, initial + refined partition in one launch); with `plain`,
    their plain versions.  Returns (pca, oriented, initial, refined)."""
    rows, o, w = consts
    if plain:
        pca = normals.pca_normals_plain(pos, idx, valid)
        nrm = normals.orient_normals_plain(pos, pca, idx, valid, rows)
        p0 = segmentation.initial_segmentation_plain(nrm, o, w)
        return pca, nrm, p0, segmentation.refine_segmentation_plain(nrm, p0, idx, valid, o, 3.0, 10)
    pca = normals.pca_normals(pos, idx, valid)
    nrm = normals.orient_normals(pos, pca, idx, valid, rows)
    return (pca, nrm, *segmentation.segment_partitions(nrm, o, w, idx, valid, 3.0, 10))


def segment_check(dev, normals, segmentation, args, out_k, out_p):
    """Kernel F's chain against its plain version: normals to NORMAL_ATOL;
    given the plain version's normals, the orientation and the partitions
    of both partition entries (`segment_partitions`,
    `refine_segmentation`) identical; the device centroid equal to its
    tensor twin; the chain run again under
    torch.cuda.set_sync_debug_mode("error"), so that a host wait fails, in
    CHAIN_LAUNCHES launches.  Returns (the detail line, the (orientation,
    refinement) sweeps the kernel chain ran)."""
    pos, idx, valid = args
    consts = chain_consts(segmentation, pos)
    rows, o, w = consts
    err = float((out_k[0] - out_p[0]).abs().max())
    got_o, cen, _ = normals.orient_launch(pos, out_p[0], idx, valid, rows)
    same = torch.equal(got_o, out_p[1])
    cen_ok = torch.equal(cen, normals.orientation_centroid_device(pos, rows))
    p0, p1 = segmentation.segment_partitions(out_p[1], o, w, idx, valid, 3.0, 10)
    same = same and torch.equal(p0, out_p[2]) and torch.equal(p1, out_p[3])
    same = same and torch.equal(
        segmentation.refine_segmentation(out_p[1], out_p[2], idx, valid, o, 3.0, 10), out_p[3])
    torch.cuda.synchronize()
    before = dev.LAUNCHES["segment"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = segment_chain(normals, segmentation, pos, idx, valid, consts, plain=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    chain_launches = dev.LAUNCHES["segment"] - before
    same = same and all(torch.equal(a, b) for a, b in zip(again, out_k))
    # the sweeps of the kernel chain's own stages (they end once one
    # changes nothing), for its bound
    got_o, _, o_flags = normals.orient_launch(pos, out_k[0], idx, valid, rows)
    *got_p, p_flags = segmentation.partition_launch(out_k[1], o, w, idx, valid, 3.0, 10, None)
    same = same and torch.equal(got_o, out_k[1]) and all(
        torch.equal(a, b) for a, b in zip(got_p, out_k[2:]))
    sweeps = (normals.sweeps_run(o_flags), normals.sweeps_run(p_flags))
    agree = float((out_k[3] == out_p[3]).float().mean())
    if err > NORMAL_ATOL or not same or not cen_ok or chain_launches != CHAIN_LAUNCHES:
        raise AssertionError(f"segment: kernel differs from its plain version (normals max "
                             f"abs err {err}, stages identical {same}, centroid {cen_ok}, "
                             f"{chain_launches} launches a chain)")
    return (f"normals max abs err {err:.3g} (tolerance {NORMAL_ATOL}); orientation, "
            f"initial and refined partitions identical given the same normals; device "
            f"centroid equal to its tensor twin; {chain_launches} launches a chain, no host "
            f"synchronisation (sync debug mode \"error\"); sweeps run: orientation "
            f"{sweeps[0]} of {normals.ORIENT_ITERATIONS}, refinement {sweeps[1]} of 10; "
            f"chain-to-chain refined agreement {agree:.6f}"), sweeps


def cc_all_check(cc, calls) -> None:
    """Kernel G against its plain version on every captured call, exactly;
    times round 0 and the sparsest round (call and CUDA-graph device
    times)."""
    act = [int(c[3].sum()) for c in calls]
    for i, c in enumerate(calls):
        err = max_abs_err(cc.cc_labels_device(*c), cc.cc_labels_plain(*c))
        if err != 0:
            raise AssertionError(f"cc_labels call {i} ({act[i]} active of {c[0].shape[0]}): "
                                 f"kernel differs from its plain version (max abs err {err})")
    print(f"cc_labels: all {len(calls)} captured calls of the warm-up exact; active rows "
          f"per call {act}")
    for what, i in (("round 0 of frame 0", 0), ("the sparsest round", act.index(min(act)))):
        c = calls[i]
        out = cc.cc_labels_device(*c)
        kern = lambda c=c: cc.cc_labels_device(*c)
        k1, k2 = time_ms(kern, 20), time_ms(kern, 20)
        b_ms, b_by = bounds("cc_labels", c, out)
        print(f"cc_labels, {what} ({act[i]} active of {c[0].shape[0]}): kernel "
              f"{k1:.4f}/{k2:.4f} ms, device {graph_ms(kern):.4f} ms a call (CUDA graph "
              f"replay), bound {b_ms:.4f} ms ({b_by})")


def front_phase(dev):
    """Steps 6-9: kernels E-H on the encoder front end.  Returns (rows,
    launches)."""
    import numpy as np

    from vpcc_tpu_torch import encoder as enc_mod
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import cc, coverage, neighbors, normals, segmentation
    from vpcc_tpu_torch.utils.checksum import array_md5
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads(FRONT_DIGESTS.read_text())
    ref_parts = np.load(FRONT_PARTITIONS)
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    t0 = time.perf_counter()
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in ref["seeds"]]
    if [f.point_count for f in frames] != ref["source_points"]:
        raise AssertionError("synthetic frames differ from the JAX package's")
    n = len(frames)
    print(f"front end: {n} bench frames made in {time.perf_counter() - t0:.1f}s, "
          f"points {[f.point_count for f in frames]}")

    # 6. warm-up, capturing each kernel's largest call
    wrappers = {
        "grid_knn": (neighbors, "knn"),
        "segment": (normals, "pca_normals"),
        "cc_labels": (cc, "cc_labels_device"),
        "coverage": (coverage, "covered_radius_slab"),
    }
    t0 = time.perf_counter()
    cc_calls = []    # every kernel G call of the warm-up, in order
    cov_calls = []   # every kernel H call, with its query tensor's key
    with Capture(wrappers) as cap:
        cap_spy, cap_cov = cc.cc_labels_device, coverage.covered_radius_slab

        def cc_spy(*a):
            cc_calls.append([t.clone() for t in a])
            return cap_spy(*a)

        def cov_spy(*a):
            # a frame's rounds share the query tensor; its address alone
            # may recur in the next frame, its first row too
            key = (a[1].data_ptr(), a[1].shape[0], tuple(a[1][0].tolist()))
            cov_calls.append((key, [copy_arg(t) for t in a]))
            return cap_cov(*a)

        # the Capture restores the wrappers
        cc.cc_labels_device, coverage.covered_radius_slab = cc_spy, cov_spy
        Encoder(cfg, device="cuda").encode_gof_front(frames)
        torch.cuda.synchronize()
    print(f"cold front end: {time.perf_counter() - t0:.2f}s for {n} frames")
    print_calls(cap.counts, "the front-end path", n)
    missing = sorted(set(wrappers) - set(cap.calls))
    if missing:
        raise AssertionError(f"kernels never called on the front end: {missing}")

    # 7. kernel == plain version on the card, and times in turns
    rows = {}
    _, (grid, q), kw = cap.calls["grid_knn"]
    k, bucket = kw["k"], kw["bucket"]
    checks = {
        "grid_knn": (lambda: neighbors.knn(grid, q, k=k, bucket=bucket),
                     lambda: neighbors.knn_plain(grid, q, k=k, bucket=bucket),
                     (grid, q, 3 * bucket)),
    }
    _, seg_args, _ = cap.calls["segment"]
    consts = chain_consts(segmentation, seg_args[0])
    checks["segment"] = (
        lambda: segment_chain(normals, segmentation, *seg_args, consts, plain=False),
        lambda: segment_chain(normals, segmentation, *seg_args, consts, plain=True), seg_args)
    _, cc_args, _ = cap.calls["cc_labels"]
    checks["cc_labels"] = (lambda: cc.cc_labels_device(*cc_args),
                           lambda: cc.cc_labels_plain(*cc_args), cc_args)
    _, cov_args, _ = cap.calls["coverage"]
    checks["coverage"] = (lambda: coverage.covered_radius_slab(*cov_args),
                          lambda: coverage.covered_radius_slab_plain(*cov_args), cov_args)
    cc_all_check(cc, cc_calls)
    coverage_all_check(dev, coverage, cov_calls)
    del cov_calls
    for name in FRONT_KERNELS:
        kern, plain, args = checks[name]
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        if name == "cc_labels":
            detail = (f"exact (max abs err {max_abs_err(out_k, out_p)}), round 0 of the "
                      f"largest frame, device {graph_ms(kern):.4f} ms a call (CUDA graph replay)")
        if name == "segment":
            # normals to a tolerance; the later stages fed the plain
            # version's normals, so their results must be identical
            err = float((out_k[0] - out_p[0]).abs().max())
            detail, sweeps = segment_check(dev, normals, segmentation, args, out_k, out_p)
            b_out = (out_k[0], out_k[3])
        else:
            err = max_abs_err(out_k, out_p)
            if err != 0:
                raise AssertionError(f"{name}: kernel differs from its plain version "
                                     f"(max abs err {err})")
            if name != "cc_labels":
                detail = f"exact (max abs err {err})"
            b_out = out_k
            if name == "grid_knn":
                detail += f", device {graph_ms(kern):.4f} ms a call (CUDA graph replay), k={k}"
        (k1, k2), (p1, p2) = time_turns(kern, plain)
        b_ms, b_by = bounds(name, args, b_out,
                            sweeps=sweeps if name == "segment" else None)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        print(f"{name}: {detail}; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); inputs {shapes}")
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

    # 8. the main path, counted and timed; the spies keep references to
    # each frame's k-NN result and partitions for the checks afterwards
    seen = {"knn": [], "partitions": []}
    spied = [(neighbors, "knn", "knn"), (enc_mod, "segment_partitions", "partitions")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in spied]
    for (mod, attr, key), (_, _, fn) in zip(spied, saved):
        def spy(*a, _fn=fn, _key=key, **kw):
            out = _fn(*a, **kw)
            seen[_key].append(out)
            return out
        setattr(mod, attr, spy)
    try:
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Capture({k: wrappers[k] for k in ("cc_labels", "segment", "coverage")},
                     keep=False) as g_calls:
            out = Encoder(cfg, device="cuda").encode_gof_front(frames)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(dev.LAUNCHES)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    print(f"cc_labels on the front-end path: {launches['cc_labels']} launches for "
          f"{g_calls.counts['cc_labels']} calls")
    if launches["cc_labels"] != CC_LAUNCHES * g_calls.counts["cc_labels"]:
        raise AssertionError(f"cc_labels: expected {CC_LAUNCHES} launches a call")
    print(f"segment on the front-end path: {launches['segment']} launches for "
          f"{g_calls.counts['segment']} chains")
    if launches["segment"] != CHAIN_LAUNCHES * g_calls.counts["segment"]:
        raise AssertionError(f"segment: expected {CHAIN_LAUNCHES} launches a chain")
    one_a_call("coverage", launches, g_calls.counts, "the front-end path")
    split = {f: sum(getattr(o.stats, f) for o in out) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s")}
    print(f"warm front end: {dt:.3f}s for {n} frames = {dt / n:.4f} s/frame; per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"launches on the front-end path: {launches}")
    idle = [k for k in FRONT_KERNELS if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the front-end path: {idle}")
    agree = {"initial": [], "refined": []}
    for i, r in enumerate(ref["frames"]):
        idx, d2 = seen["knn"][i]
        if (array_md5(idx.cpu().numpy(), "<i4"), array_md5(d2.cpu().numpy(), "<i4")) != \
                (r["knn_idx_md5"], r["knn_d2_md5"]):
            raise AssertionError(f"frame {i}: k-NN digests differ from the JAX package's")
        for key, part in zip(agree, seen["partitions"][i]):
            agree[key].append(float(np.mean(part.cpu().numpy() == ref_parts[f"{key}_{i}"])))
    own = [front_digests(fr) == {k: r[k] for k in front_digests(fr)}
           for fr, r in zip(out, ref["frames"])]
    print(f"k-NN digests: all {n} frames equal the JAX package's")
    print("partition agreement with the JAX package per frame: "
          + "; ".join(f"{key} " + ", ".join(f"{a:.6f}" for a in v) for key, v in agree.items()))
    if min(agree["initial"] + agree["refined"]) < PARTITION_FLOOR:
        raise AssertionError(f"partition agreement below {PARTITION_FLOOR}")
    print(f"own-path atlas digests equal the JAX package's: {own} "
          f"(patches {[len(fr.patches) for fr in out]})")

    # 9. patch generation driven by the committed JAX partitions
    enc = Encoder(cfg, device="cuda")
    segs = [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
        ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]
    driven = Encoder(cfg, device="cuda").encode_gof_front(frames, segs=segs)
    for i, (fr, r) in enumerate(zip(driven, ref["frames"])):
        got = front_digests(fr)
        bad = [k for k in got if got[k] != r[k]]
        if bad:
            raise AssertionError(f"frame {i} (JAX partitions): {bad} differ from the JAX digests")
        if not np.all(np.isfinite(fr.cover_dist2[fr.cover_dist2 != np.inf])):
            raise AssertionError(f"frame {i}: non-finite coverage distances")
    print(f"JAX-partition-driven front end: all {n} frames match the JAX digests "
          f"(patches {[len(fr.patches) for fr in driven]}, sizes "
          f"{sorted({(fr.width, fr.height) for fr in driven})})")
    return rows, launches, (cfg, frames, segs)


def f8_plane(h: int, w: int, planes: int = 0, seed: int = 8):
    """A crafted (h, w) int32 plane (planes > 0: a (planes, h, w) stack)
    and its occupancy (per plane for a stack): values below 2^24 on 5 % of
    the pixels, the top-left (h/4, w/4) block empty, so that block sums pass
    2^24 from level 3 and the empty block reads a deep level."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (planes, h, w) if planes else (h, w)
    img = rng.integers(0, 1 << 24, shape).astype(np.int32)
    occ = (rng.random(shape) < 0.05).astype(np.uint8)
    occ[..., : h // 4, : w // 4] = 0
    return torch.as_tensor(img, device="cuda"), torch.as_tensor(occ, device="cuda")


def f8_check(padding) -> None:
    """Kernel L against its plain version on crafted planes whose block sums
    pass 2^24: 256x256 and 512x512 (XLA's orders, the pairwise levels), a
    (3, 512, 512) stack with an occupancy per plane, and 1216x1280 (an
    atlas shape whose order is not established: both count the blocks past
    2^24 alike)."""
    for h, w, planes in ((256, 256, 0), (512, 512, 0), (512, 512, 3), (1216, 1280, 0)):
        img, occ = f8_plane(h, w, planes)
        padding.reset_inexact()
        out_k = padding.push_pull_round(img, occ)
        n_k = padding.inexact_blocks()
        padding.reset_inexact()
        out_p = padding.push_pull_round_plain(img, occ)
        n_p = padding.inexact_blocks()
        err = max_abs_err(out_k, out_p)
        print(f"push_pull on the crafted {tuple(img.shape)} plane (orders "
              f"{padding.push_order(h, w)}): max abs err {err}, blocks of unknown order past "
              f"2^24 {n_k} (plain {n_p})")
        if err != 0 or n_k != n_p:
            raise AssertionError("push_pull differs from its plain version on a crafted plane")
    padding.reset_inexact()


def pp_launches(padding, img, occ) -> int:
    """Kernel L's launches for one `push_pull_round` call, as its tile plan
    makes them (1 where the pyramid has at most 5 levels or a side is odd,
    else 3)."""
    P, H, W = (1, *img.shape) if img.ndim == 2 else img.shape
    return padding.push_pull_plan(P, H, W, occ.ndim == 3, padding.PUSH_TOP_SMEM)[0]


def lb_wrappers(padding, hevc) -> tuple:
    """Capture names of kernel L's and B's wrappers and the rename that
    files each L call under the launches its tile plan makes
    ("push_pull.3")."""
    return ({"push_pull": (padding, "push_pull_round"), "half_pel_mc": (hevc, "half_pel_mc")},
            {"push_pull": lambda a, kw: f"push_pull.{pp_launches(padding, *a[:2])}"})


def lb_launch_check(launches, counts, where: str) -> None:
    """Kernel L launches as its tile plan says (at most three a call) and
    kernel B once a call, on a path whose calls `counts` holds (see
    `lb_wrappers`)."""
    pp = {int(k.split(".")[1]): v for k, v in counts.items() if k.startswith("push_pull.")}
    want = sum(k * v for k, v in pp.items())
    print(f"push_pull on {where}: {launches['push_pull']} launches for {sum(pp.values())} "
          f"calls (launches a call x calls: {pp})")
    if launches["push_pull"] != want or any(k > 3 for k in pp):
        raise AssertionError(f"push_pull: {launches['push_pull']} launches on {where}, its tile "
                             f"plan makes {want}")
    one_a_call("half_pel_mc", launches, counts, where)


def pp_all_check(dev, padding, calls, where: str, need_stack: str = "") -> None:
    """Kernel L against its plain version on every call in `calls`, bit for
    bit with the same count of blocks of unknown order past 2^24, in the
    launches its tile plan makes; the largest once under sync debug mode
    "error", with its call and device times.  `need_stack`: "shared" or
    "planar", a stack some call must be (six planes under one occupancy:
    `fill_rgb`'s attribute call; an occupancy per plane: the level path)."""
    if not calls:
        raise AssertionError(f"push_pull: no call captured on {where}")
    shapes = collections.Counter()
    for i, (img, occ) in enumerate(calls):
        padding.reset_inexact()
        before = dev.LAUNCHES["push_pull"]
        got = padding.push_pull_round(img, occ)
        n_k, n = padding.inexact_blocks(), dev.LAUNCHES["push_pull"] - before
        padding.reset_inexact()
        want = padding.push_pull_round_plain(img, occ)
        if not torch.equal(got, want) or padding.inexact_blocks() != n_k:
            raise AssertionError(f"push_pull call {i} on {where} ({tuple(img.shape)}): kernel "
                                 "differs from its plain version")
        if n != pp_launches(padding, img, occ) or n > 3:
            raise AssertionError(f"push_pull call {i} on {where}: {n} launches")
        shapes[(tuple(img.shape), tuple(occ.shape), n)] += 1
    padding.reset_inexact()
    stack = {"shared": lambda img, occ: img.ndim == 3 and img.shape[0] == 6 and occ.ndim == 2,
             "planar": lambda img, occ: occ.ndim == 3}.get(need_stack)
    if stack and not any(stack(*a) for a in calls):
        raise AssertionError(f"push_pull on {where}: no {need_stack}-occupancy stack")
    big = max(calls, key=lambda a: a[0].numel())
    fn = lambda: padding.push_pull_round(*big)
    n = no_sync_launches(dev, "push_pull", fn)
    print(f"push_pull: all {len(calls)} captured calls of {where} exact (and the count of "
          "blocks of unknown order past 2^24); (planes, occupancy, launches) x calls: "
          + ", ".join(f"{k} x {v}" for k, v in shapes.items())
          + f"; the largest: {n} launches, no host synchronisation (sync debug mode \"error\"), "
          f"call {time_ms(fn, 20):.4f} ms, device {graph_ms(fn):.4f} ms (CUDA graph replay)")


def b_all_check(dev, hevc, calls, where: str, bs=None) -> None:
    """Kernel B against its plain version on every call in `calls`, bit for
    bit, one launch a call; the largest once under sync debug mode "error",
    with its call and device times.  `bs`: a CU size some call must have."""
    if not calls:
        raise AssertionError(f"half_pel_mc: no call captured on {where}")
    shapes = collections.Counter()
    phases = collections.Counter()
    for i, a in enumerate(calls):
        before = dev.LAUNCHES["half_pel_mc"]
        got = hevc.half_pel_mc(*a)
        if dev.LAUNCHES["half_pel_mc"] - before != 1:
            raise AssertionError(f"half_pel_mc call {i} on {where}: not one launch")
        if not torch.equal(got, hevc.half_pel_mc_plain(*a)):
            raise AssertionError(f"half_pel_mc call {i} on {where} ({tuple(a[0].shape)}, bs "
                                 f"{a[3]}): kernel differs from its plain version")
        shapes[(tuple(a[0].shape), a[3])] += 1
        mv = a[1].reshape(-1, 2)
        phases.update(((mv[:, 0] & 1) * 2 + (mv[:, 1] & 1)).tolist())
    if bs is not None and not any(a[3] == bs for a in calls):
        raise AssertionError(f"half_pel_mc on {where}: no call at {bs}-px CUs")
    big = max(calls, key=lambda a: a[0].numel())
    fn = lambda: hevc.half_pel_mc(*big)
    n = no_sync_launches(dev, "half_pel_mc", fn)
    if n != 1:
        raise AssertionError(f"half_pel_mc on {where}: {n} launches a call, expected 1")
    print(f"half_pel_mc: all {len(calls)} captured calls of {where} exact, one launch a call; "
          "(planes, bs) x calls: " + ", ".join(f"{k} x {v}" for k, v in shapes.items())
          + "; CUs by phase (fy, fx): " + ", ".join(f"{k >> 1}{k & 1} {v}"
                                                     for k, v in sorted(phases.items()))
          + f"; the largest: one launch, no host synchronisation (sync debug mode \"error\"), "
          f"call {time_ms(fn, 20):.4f} ms, device {graph_ms(fn):.4f} ms (CUDA graph replay)")


def occupied_psnr(src, rec, occ, peak: float = 255.0) -> float:
    import numpy as np

    m = occ != 0
    mse = float(np.mean((src[m].astype(np.float64) - rec[m].astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def cu_agreement(a: dict, b: dict) -> float:
    """Share of 32x32 CUs whose parsed syntax (split flags, modes, levels)
    is the same in two payloads of one plane."""
    import numpy as np

    same = np.ones(a["s32"].shape, bool)
    for k in ("s32", "m32", "c32", "s16", "modes", "c16"):
        x, y = a[k], b[k]
        same &= (x == y).reshape(x.shape[0], x.shape[1], -1).all(-1)
    return float(same.mean())


def copy_arg(a):
    """A copy of one captured argument: a tensor, or a list of tensors (a
    batch of images), cloned; anything else as it is."""
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, (list, tuple)) and a and all(torch.is_tensor(t) for t in a):
        return [t.clone() for t in a]
    return a


class CallLog:
    """Keeps a copy of the arguments of every call of mod.attr (whose first
    tensor, or first list of tensors, is not empty) while it is entered: the
    positional ones in `calls`, the keyword ones in `kws`."""

    def __init__(self, mod, attr):
        self.mod, self.attr, self.calls, self.kws = mod, attr, [], []

    def __enter__(self):
        self.real = real = getattr(self.mod, self.attr)

        def spy(*args, **kw):
            first = next(a if torch.is_tensor(a) else a[0] for a in args
                         if torch.is_tensor(a) or isinstance(a, (list, tuple)))
            if first.numel():
                self.calls.append([copy_arg(a) for a in args])
                self.kws.append({k: copy_arg(v) for k, v in kw.items()})
            return real(*args, **kw)

        setattr(self.mod, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


def motion_all_check(hevc, calls, where: str) -> None:
    """Kernel J against its plain version on every call in `calls`, the
    vectors and the rates bit for bit."""
    if not calls:
        raise AssertionError(f"motion_search: no call captured on {where}")
    for i, a in enumerate(calls):
        mv, cost = hevc.motion_search(*a)
        mv_p, cost_p = hevc.motion_search_plain(*a)
        if not (torch.equal(mv, mv_p) and torch.equal(cost, cost_p)):
            raise AssertionError(f"motion_search call {i} on {where} ({tuple(a[0].shape)}, bs "
                                 f"{a[4]}): kernel differs from its plain version")
    shapes = collections.Counter((tuple(a[0].shape), a[4]) for a in calls)
    print(f"motion_search: all {len(calls)} captured calls of {where} exact (mv and cost); "
          "(planes, bs) x calls: " + ", ".join(f"{k} x {v}" for k, v in shapes.items()))


def sao_pair(search, apply, args, kw):
    """Kernel K's search then apply (entries or plain versions) on the
    fused entry's arguments: (rec_sao, cls, off)."""
    src, rec, lam, w, maxv = args
    cls, off = search(src, rec, lam, w, **kw)
    return apply(rec, cls, off, maxv, **kw), cls, off


def sao_check(hevc, args, kw, where: str) -> None:
    """Kernel K's fused entry on a captured encoder call against the plain
    search then apply and against its own two entries, bit for bit; prints
    the device times of the fused launch and of the two entries."""
    fused = lambda: hevc.sao_search_apply(*args, **kw)
    pair = lambda: sao_pair(hevc.sao_search, hevc.sao_apply, args, kw)
    out = fused()
    err_p = max_abs_err(tuple(out), tuple(sao_pair(hevc.sao_search_plain,
                                                   hevc.sao_apply_plain, args, kw)))
    err_e = max_abs_err(tuple(out), tuple(pair()))
    torch.cuda.synchronize()
    if err_p or err_e:
        raise AssertionError(f"sao_search_apply ({where}): differs from the plain search + "
                             f"apply (max abs err {err_p}) or from the two entries ({err_e})")
    print(f"sao_search_apply ({where}, region {kw.get('region', 32)}, planes "
          f"{tuple(args[1].shape)}): exact against the plain search + apply and against "
          f"sao_search + sao_apply; device {graph_ms(fused):.4f} ms a call, the two entries "
          f"{graph_ms(pair):.4f} ms (CUDA graph replay)")


def geometry_phase(dev, cfg, frames, segs):
    """Steps 10-12: kernels I-L on the geometry video encoder.  Returns
    (rows, launches)."""
    import numpy as np

    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.apps import profile_encode_geometry as prof, profiling
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import padding
    from vpcc_tpu_torch.video import codecs, hevc

    n = len(frames)
    # 10. warm-up, capturing each kernel's largest call
    wrappers = {
        "wavefront_encode32": (hevc, "wavefront_encode32"),
        "motion_search": (hevc, "motion_search"),
        "sao": (hevc, "sao_search_apply"),
        "push_pull": (padding, "push_pull_round"),
    }
    t0 = time.perf_counter()
    with Capture(wrappers) as cap, CallLog(hevc, "motion_search") as j_calls, \
            CallLog(padding, "push_pull_round") as l_calls, \
            CallLog(hevc, "half_pel_mc") as b_calls:
        Encoder(cfg, device="cuda").encode_gof_geometry(frames, segs=segs)
        torch.cuda.synchronize()
    print(f"cold geometry encode: {time.perf_counter() - t0:.2f}s for {n} frames")
    print_calls(cap.counts, "the geometry path", n)
    missing = sorted(set(wrappers) - set(cap.calls))
    if missing:
        raise AssertionError(f"kernels never called on the geometry path: {missing}")

    # 11. kernel == plain version on the card, and times in turns
    _, enc_args, _ = cap.calls["wavefront_encode32"]
    _, ms_args, _ = cap.calls["motion_search"]
    _, sao_args, sao_kw = cap.calls["sao"]
    _, pp_args, _ = cap.calls["push_pull"]
    sao_check(hevc, sao_args, sao_kw, "the geometry path")
    motion_all_check(hevc, j_calls.calls, "the geometry path's warm-up")
    pp_all_check(dev, padding, l_calls.calls, "the geometry path's warm-up")
    b_all_check(dev, hevc, b_calls.calls, "the geometry path's warm-up", bs=32)
    del j_calls, l_calls, b_calls

    checks = {
        "wavefront_encode32": (lambda: hevc.wavefront_encode32(*enc_args),
                               lambda: hevc.wavefront_encode32_plain(*enc_args), enc_args, 5, 1),
        "motion_search": (lambda: hevc.motion_search(*ms_args),
                          lambda: hevc.motion_search_plain(*ms_args), ms_args, 20, 3),
        "sao": (lambda: hevc.sao_search_apply(*sao_args, **sao_kw),
                lambda: sao_pair(hevc.sao_search_plain, hevc.sao_apply_plain, sao_args, sao_kw),
                sao_args, 20, 3),
        "push_pull": (lambda: padding.push_pull_round(*pp_args),
                      lambda: padding.push_pull_round_plain(*pp_args), pp_args, 20, 3),
    }
    print(f"wavefront_encode32 check input: {int((enc_args[5] > 0).sum())} of "
          f"{enc_args[5].numel()} CUs with an MV rate (a motion-searched plane)")
    rows = {}
    for name in GEOMETRY_KERNELS:
        kern, plain, args, reps_k, reps_p = checks[name]
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(tuple(out_k), tuple(out_p)) if isinstance(out_k, tuple) \
            else max_abs_err(out_k, out_p)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        (k1, k2), (p1, p2) = time_turns(kern, plain, reps_k=reps_k, reps_p=reps_p)
        b_ms, b_by = bounds(name, args, out_k)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        print(f"{name}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}); inputs {shapes}")
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    f8_check(padding)

    # 12. the main path, counted and timed
    enc = Encoder(cfg, device="cuda")
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    lb_wrap, lb_name = lb_wrappers(padding, hevc)
    t0 = time.perf_counter()
    with Capture({"sao": wrappers["sao"], **lb_wrap}, rename=lb_name, keep=False) as k_calls:
        out = enc.encode_gof_geometry(frames, segs=segs)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dev.LAUNCHES)
    one_a_call("sao", launches, k_calls.counts, "the geometry path")
    lb_launch_check(launches, k_calls.counts, "the geometry path")
    split = {f: sum(getattr(o.stats, f) for o in out) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s",
                       "video_s", "reconstruct_s")}
    print(f"warm geometry encode: {dt:.3f}s for {n} frames = {dt / n:.4f} s/frame; per "
          "frame " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"launches on the geometry path: {launches}")
    idle = [k for k in GEOMETRY_KERNELS if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the geometry path: {idle}")
    profiling.print_trace(*prof.trace_p_frame(enc, frames, out, segs),
                          "one warm P-frame (frame 1, JAX partitions)", top=12)

    # every payload decodes to the encoder's planes; the reconstruction is
    # the seam's on those planes
    d = torch.device("cuda")
    parent, _ = enc.gof_structure(n)
    decs = [codecs.GeometrySubstreamDecoder(cfg, d) for _ in range(2)]
    bank = {}
    for i, fr in enumerate(out):
        g0 = decs[0].decode(fr.geo_payloads[0],
                            temporal_ref=bank.get(parent[i]) if i else None)
        g1 = decs[1].decode(fr.geo_payloads[1], layer_ref=g0)
        for k, (a, b) in enumerate(((g0, fr.geo_dec[0]), (g1, fr.geo_dec[1]))):
            if not torch.equal(a, b):
                raise AssertionError(f"frame {i} D{k}: the decoder's plane differs from "
                                     "the encoder's reconstruction")
        if i in set(parent[i + 1:]):
            bank[i] = g0
        rc = pipeline.reconstruct_frame(fr.front.occ_rec, [g0, g1], fr.front.block_to_patch,
                                        fr.front.patches, cfg, d)
        for field, a, b in zip(rc._fields, rc, fr.recon):
            if torch.is_tensor(a) and not torch.equal(a, b):
                raise AssertionError(f"frame {i}: reconstruction field {field} differs")
        if not torch.isfinite(fr.recon.pos.float()).all():
            raise AssertionError(f"frame {i}: non-finite reconstructed positions")
    print(f"cross-decode: all {2 * n} geometry payloads decode exactly to the encoder's "
          f"planes; reconstructions equal the seam's ({[int(fr.recon.pos.shape[0]) for fr in out]} points)")

    # the RD gate against the JAX encoder's geometry substreams
    jax_geo = []
    real = codecs.GeometrySubstreamDecoder.decode

    def spy(self, payload, *a, **kw):
        plane = real(self, payload, *a, **kw)
        jax_geo.append((payload, plane.cpu().numpy()))
        return plane

    codecs.GeometrySubstreamDecoder.decode = spy
    try:
        Decoder(device="cuda").decode(FIXTURE.read_bytes())
    finally:
        codecs.GeometrySubstreamDecoder.decode = real
    if len(jax_geo) != 2 * n:
        raise AssertionError(f"fixture holds {len(jax_geo)} geometry frames, expected {2 * n}")
    port_bytes = sum(len(p) for fr in out for p in fr.geo_payloads)
    jax_bytes = sum(len(p) for p, _ in jax_geo)
    d_bytes = port_bytes / jax_bytes - 1.0
    rows_rd, worst = [], 0.0
    identical = 0
    for i, fr in enumerate(out):
        for k, src in enumerate((fr.front.frame.geometry0, fr.front.frame.geometry1)):
            jp, jrec = jax_geo[2 * i + k]
            pp = fr.geo_payloads[k]
            identical += pp == jp
            ps_port = occupied_psnr(src, fr.geo_dec[k].cpu().numpy(), fr.front.frame.occupancy)
            ps_jax = occupied_psnr(src, jrec, fr.front.frame.occupancy)
            agree = cu_agreement(hevc.parse_planes32(pp[1:]), hevc.parse_planes32(jp[1:]))
            worst = max(worst, abs(ps_port - ps_jax))
            rows_rd.append(f"f{i}D{k} {len(pp)}/{len(jp)} B {ps_port:.4f}/{ps_jax:.4f} dB "
                           f"CU {agree:.4f}")
    print("per plane (port/JAX bytes, occupied PSNR, CU syntax agreement): "
          + "; ".join(rows_rd))
    print(f"RD against the JAX fixture: geometry bytes {port_bytes} vs {jax_bytes} "
          f"({100 * d_bytes:+.4f} %), worst plane PSNR delta {worst:.4f} dB; "
          f"{identical} of {2 * n} payloads byte-identical to JAX's")
    if abs(d_bytes) > RD_BYTES_TOL or worst > RD_PSNR_TOL_DB:
        raise AssertionError(f"RD gate: bytes {100 * d_bytes:+.3f} % (limit "
                             f"{100 * RD_BYTES_TOL} %), PSNR delta {worst:.3f} dB "
                             f"(limit {RD_PSNR_TOL_DB})")
    return rows, launches


def luma_psnr(coded, decoded, occ) -> float:
    """Occupied-pixel PSNR of two (H, W) luma planes (peak 255), as the
    attribute reference data computes it."""
    import numpy as np

    m = np.asarray(occ) != 0
    err = np.asarray(coded, np.float64)[m] - np.asarray(decoded, np.float64)[m]
    mse = float(np.mean(err * err))
    return float("inf") if mse == 0 else float(10.0 * np.log10(255.0 * 255.0 / mse))


def recolor_inputs(recolor, neighbors, args, cfg):
    """The inputs of kernel M's two entries on one recolor call
    (`transfer_colors_compact`'s source positions and colors, targets),
    with its k-NN sweeps (kernel E) run once on the compacted lists:
    (src_pos, src_col, tgt, order, sorted keys, the inexact targets' k-NN,
    the unmatched sources' nearest targets)."""
    src_pos, src_col, tgt = args[:3]
    bits = cfg.geometryBitDepth3D
    order, sk = recolor.sorted_source_keys(src_pos, bits)
    _, _, _, tq, _, sq = recolor.exact_compact(order, sk, src_pos, tgt, bits)
    idx, d2 = neighbors.knn(neighbors.build_grid(src_pos, bits), tq,
                            k=cfg.numNeighborsColorTransferFwd, bucket=6)
    tidx, td2 = neighbors.nearest(neighbors.build_grid(tgt, bits), sq, bucket=6)
    return src_pos, src_col.to(torch.uint8).contiguous(), tgt, order, sk, idx, d2, tidx, td2


def recolor_entries(recolor, inputs, cfg, plain: bool):
    """Kernel M's two entries (or their plain versions) on `inputs`
    (`recolor_inputs`): (exact_idx, has_exact, inexact targets, their
    positions, unmatched sources, their positions, colors)."""
    src_pos, src_col, tgt, order, sk, idx, d2, tidx, td2 = inputs
    sfx = "_plain" if plain else ""
    ex = getattr(recolor, "exact_compact" + sfx)(order, sk, src_pos, tgt, cfg.geometryBitDepth3D)
    eidx, has, iidx, _, uidx, _ = ex
    out = getattr(recolor, "blend_merge" + sfx)(
        src_col, eidx, has, iidx, idx, d2, uidx, tidx, td2, float(cfg.maxGeometryDist2Fwd),
        float(cfg.maxColorDist2Fwd), float(cfg.distOffsetFwd), float(cfg.maxGeometryDist2Bwd))
    return (*ex, out)


def recolor_all_check(dev, recolor, neighbors, calls, cfg, where: str) -> None:
    """Kernel M's two entries against their plain versions on every
    `transfer_colors_compact` call in `calls` (a CallLog), every output bit
    for bit, two launches a call; the largest call with one host
    synchronisation (sync debug mode "warn"), its call and device times."""
    if not calls.calls:
        raise AssertionError(f"recolor: no call captured on {where}")
    for i, a in enumerate(calls.calls):
        m_in = recolor_inputs(recolor, neighbors, a, cfg)
        torch.cuda.synchronize()
        before = dev.LAUNCHES["recolor"]
        got = recolor_entries(recolor, m_in, cfg, plain=False)
        launches = dev.LAUNCHES["recolor"] - before
        want = recolor_entries(recolor, m_in, cfg, plain=True)
        if launches != 2 or max_abs_err(got, want) != 0:
            raise AssertionError(f"recolor call {i} on {where}: {launches} launches, kernel "
                                 "differs from its plain version")
    a, kw = max(zip(calls.calls, calls.kws), key=lambda c: c[0][2].shape[0])
    fn = lambda: recolor.transfer_colors_compact(*a, **kw)
    syncs = host_syncs(fn)
    if syncs != 1:
        raise AssertionError(f"transfer_colors_compact on {where}: {syncs} host "
                             "synchronisations a call, expected 1")
    print(f"recolor: all {len(calls.calls)} captured calls of {where} exact (exact matches, "
          f"both lists with their positions, colors), two launches a call; the largest "
          f"transfer_colors_compact: one host synchronisation (the counts), call "
          f"{time_ms(fn, 20):.4f} ms, device {device_ms(fn):.4f} ms (torch.profiler, kernel "
          "E's sweeps and the grid builds included)")


def gs_all_check(dev, smoothing, log, where: str) -> None:
    """Kernel D against its plain version on every call `log` (a CallLog)
    kept, bit for bit, one launch a call; the largest once under sync debug
    mode "error", its call and device times and the bytes of cell records
    it sets (the points' box) against the four whole-grid tables the
    parent filled."""
    calls = list(zip(log.calls, log.kws))
    if not calls:
        raise AssertionError(f"grid_smooth: no call captured on {where}")
    for i, (a, kw) in enumerate(calls):
        torch.cuda.synchronize()
        before = dev.LAUNCHES["grid_smooth"]
        got = smoothing.grid_smooth(*a, **kw)
        launches = dev.LAUNCHES["grid_smooth"] - before
        if launches != 1 or not torch.equal(got, smoothing.smooth_point_cloud_grid_plain(*a, **kw)):
            raise AssertionError(f"grid_smooth call {i} on {where} ({tuple(a[0].shape)}): "
                                 f"{launches} launches, kernel differs from its plain version")
    a, kw = max(calls, key=lambda c: c[0][0].shape[0])
    fn = lambda: smoothing.grid_smooth(*a, **kw)
    if no_sync_launches(dev, "grid_smooth", fn) != 1:
        raise AssertionError(f"grid_smooth on {where}: expected one launch a call")
    gs, bits = kw.get("grid_size", 8), kw.get("grid_bits", 10)
    gw = (1 << bits) // gs
    cell = torch.div(a[0], gs, rounding_mode="floor").clamp(0, gw - 1)
    box = (cell.amax(0) - cell.amin(0) + 1).tolist()
    print(f"grid_smooth: all {len(calls)} captured calls of {where} exact, one launch a call; "
          f"the largest ({tuple(a[0].shape)} points, {gw}^3 cells): no host synchronisation "
          f"(sync debug mode \"error\"), call {time_ms(fn, 20):.4f} ms, device "
          f"{device_ms(fn):.4f} ms (torch.profiler); cell records set: box {box} = "
          f"{24 * box[0] * box[1] * box[2]} bytes (the four whole-grid tables: "
          f"{24 * (gw ** 3 + 1)} bytes)")


def m_d_calls(launches, counts, where: str, n: int, m_calls=()) -> None:
    """Kernels M's and D's launches on a path (`launches`) against their
    wrappers' calls (`counts`): D once a call; `m_calls` (counter, calls,
    launches a call) for M; printed a call and a frame."""
    for name, calls, per in (("grid_smooth", counts.get("grid_smooth", 0), 1), *m_calls):
        got = launches.get(name, 0)
        print(f"{name} on {where}: {got} launches for {calls} calls ({got / max(calls, 1):g} a "
              f"call, {got / n:g} a frame)")
        if got != per * calls:
            raise AssertionError(f"{name} on {where}: {got} launches for {calls} calls, "
                                 f"expected {per} a call")


# kernel P's color entries -> the pipeline function each wraps
ATTR_FUNCS = {"attr_paint": "paint_attribute", "attr_group_dilate": "group_dilate",
              "attr_gather": "gather_decoded_colors"}


def presmooth_whole_check(smoothing, call) -> None:
    """Kernel N's whole call (`presmooth_colors`: the boundary rows, kernel
    E's k=64 sweep, the vote into a copy of the colors) against the same
    call with the plain vote: md5 equal, both timed in turns."""
    from vpcc_tpu_torch.utils.checksum import array_md5

    _, args, kw = call
    whole = lambda: smoothing.presmooth_colors(*args, **kw)

    def whole_plain():
        real = smoothing.presmooth_vote
        smoothing.presmooth_vote = smoothing.presmooth_vote_plain
        try:
            return smoothing.presmooth_colors(*args, **kw)
        finally:
            smoothing.presmooth_vote = real

    md5_k, md5_p = (array_md5(f().cpu().numpy(), "<i4") for f in (whole, whole_plain))
    if md5_k != md5_p:
        raise AssertionError(f"presmooth_colors: md5 {md5_k} with kernel N, {md5_p} with its "
                             "plain version")
    (k1, k2), (p1, p2) = time_turns(whole, whole_plain)
    print(f"presmooth_colors (kernel N's whole call, {int(args[2].sum())} boundary rows of "
          f"{args[0].shape[0]}): md5 equal ({md5_k}); call {k1:.4f}/{k2:.4f} ms, with the plain "
          f"vote {p1:.4f}/{p2:.4f} ms")


def encode_phase(dev, cfg, frames, segs):
    """Steps 13-15: kernels M-Q and the whole encoder.  Returns (rows,
    launches, (the warm encode's stream, its reconstruction))."""
    import numpy as np

    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.apps import profile_encode as prof, profiling
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import neighbors, padding, reconstruct, recolor, smoothing
    from vpcc_tpu_torch.utils.checksum import array_md5
    from vpcc_tpu_torch.video import codecs, hevc

    ref = json.loads(ATTR_DIGESTS.read_text())
    n = len(frames)
    d = torch.device("cuda")

    # 13. warm-up, capturing each kernel's largest call and, per attribute
    # plane, the coded and the decoded luma
    wrappers = {
        "recolor": (recolor, "transfer_colors_compact"),
        "presmooth": (smoothing, "presmooth_vote"),
        "deblock": (hevc, "deblock_planes"),
        "paint": (pipeline, "paint_attribute"),
        "dilate": (pipeline, "group_dilate"),
        "gather": (pipeline, "gather_decoded_colors"),
        **color_wrappers(hevc),
    }
    e_wrap = {"grid_knn": (neighbors, "knn")}
    e_name = {"grid_knn": lambda a, kw: E_CALLS.get(kw.get("k"), f"grid_knn.k{kw.get('k')}")}
    planes = []
    real_attr = codecs.AttributeSubstreamEncoder.encode
    # the spy's own conversion, bound before Capture wraps the entry: it is
    # no call of the encoder's and is not counted
    to_planes = hevc.rgb_to_planes

    def attr_spy(self, attr, *a, weight=None, **kw):
        out = real_attr(self, attr, *a, weight=weight, **kw)
        y = to_planes(torch.as_tensor(attr, device=d))[0][0]
        planes.append((len(out[0]), luma_psnr(y.cpu().numpy(), self.refs[0][0].cpu().numpy(),
                                              weight)))
        return out

    codecs.AttributeSubstreamEncoder.encode = attr_spy
    t0 = time.perf_counter()
    try:
        with Capture(wrappers) as cap, Capture(e_wrap, rename=e_name) as e_cap, \
                Capture({"presmooth_colors": (smoothing, "presmooth_colors")}) as ps_cap, \
                CallLog(hevc, "deblock_planes") as db_log, \
                CallLog(reconstruct, "generate_points") as gp_log, \
                CallLog(recolor, "transfer_colors_compact") as rc_log, \
                CallLog(smoothing, "grid_smooth") as gs_log, \
                CallLog(padding, "push_pull_round") as l_log, \
                CallLog(hevc, "half_pel_mc") as b_log:
            enc0 = Encoder(cfg, device="cuda")
            stream0, recon0 = enc0.encode_gof(frames, segs=segs)
            torch.cuda.synchronize()
    finally:
        codecs.AttributeSubstreamEncoder.encode = real_attr
    cold = time.perf_counter() - t0
    print(f"cold encode: {cold:.2f}s for {n} frames = {cold / n:.4f} s/frame; stream "
          f"{len(stream0)} bytes")
    print_calls(cap.counts + e_cap.counts, "the encode path", n)
    missing = sorted((set(wrappers) | set(E_ENCODE_ROWS)) - set(cap.calls) - set(e_cap.calls))
    if missing:
        raise AssertionError(f"kernels never called on the encode path: {missing}")

    # kernels M-P == their plain versions, timed in turns
    _, rc_args, _ = cap.calls["recolor"]
    _, ps_args, _ = cap.calls["presmooth"]
    ps_c, ps_nidx, ps_nd2, ps_bidx, ps_out, *ps_gates = ps_args
    ps_k, ps_p = ps_out.clone(), ps_out.clone()
    _, db_args, _ = cap.calls["deblock"]
    p_args, g_args, c_args = (cap.calls[k][1] for k in ("paint", "dilate", "gather"))
    m_in = recolor_inputs(recolor, neighbors, rc_args, cfg)
    checks = {
        "recolor": (lambda: recolor_entries(recolor, m_in, cfg, plain=False),
                    lambda: recolor_entries(recolor, m_in, cfg, plain=True), m_in),
        "presmooth": (lambda: smoothing.presmooth_vote(ps_c, ps_nidx, ps_nd2, ps_bidx, ps_k,
                                                       *ps_gates),
                      lambda: smoothing.presmooth_vote_plain(ps_c, ps_nidx, ps_nd2, ps_bidx,
                                                             ps_p, *ps_gates), ps_args),
        "deblock": (lambda: hevc.deblock_planes(*db_args),
                    lambda: hevc.deblock_planes_plain(*db_args), db_args),
    }
    for kname, args in zip(ATTR_ENTRIES, (p_args, g_args, c_args)):
        fn = ATTR_FUNCS[kname]
        checks[kname] = (lambda f=getattr(pipeline, fn), a=args: f(*a),
                         lambda f=getattr(pipeline, fn + "_plain"), a=args: f(*a), args)
    # kernel E's recolor (k=8, k=1) and pre-smoothing (k=64) calls
    for ename in E_ENCODE_ROWS:
        _, (grid, q), kw = e_cap.calls[ename]
        checks[ename] = (lambda g=grid, q=q, kw=kw: neighbors.knn(g, q, **kw),
                         lambda g=grid, q=q, kw=kw: neighbors.knn_plain(g, q, **kw),
                         (grid, q, 3 * kw["bucket"]))
    libs = dict(zip(("attr_paint", "attr_gather"), p_library_ms(
        "attr", p_args, c_args, pipeline.gather_decoded_colors_plain, clamp=True)))
    rows = {}
    for name, (kern, plain, args) in checks.items():
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(tuple(out_k), tuple(out_p)) if isinstance(out_k, tuple) \
            else max_abs_err(out_k, out_p)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        # kernel P's calls are short: more of them, and their device time apart
        (k1, k2), (p1, p2) = time_turns(kern, plain, reps_k=100 if name in ATTR_ENTRIES else 20)
        lib = None
        if name == "recolor":
            shapes = [tuple(a.shape) for a in rc_args[:3]] + [
                f"lists {tuple(out_k[2].shape)} {tuple(out_k[4].shape)}"]
            print(f"recolor: the two entries' device time {device_ms(kern):.4f} ms a call "
                  "(torch.profiler)")
        elif name in E_ENCODE_ROWS:
            shapes = [tuple(args[1].shape), f"k={out_k[0].shape[1]}", f"win={args[2]}"]
            print(f"{name}: device {graph_ms(kern):.4f} ms a call (CUDA graph replay)")
        elif name in ATTR_ENTRIES:
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            lib = libs.get(name)
            print(f"{name}: device {graph_ms(kern):.4f} ms a call (CUDA graph replay)")
        else:
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        b_ms, b_by = bounds("grid_knn" if name in E_ENCODE_ROWS else name, args, out_k)
        lib_txt = "" if lib is None else f", library {lib:.4f} ms"
        print(f"{name}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}){lib_txt}; "
              f"inputs {shapes}")
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err, library_ms=lib)
    presmooth_whole_check(smoothing, ps_cap.calls["presmooth_colors"])
    rest = sum(rows[k]["ms"] for k in ATTR_ENTRIES)
    rest_b = sum(rows[k]["bound_ms"] for k in ATTR_ENTRIES)
    print(f"kernel P's paint + group dilation + gather: kernel {rest:.4f} ms, bound "
          f"{rest_b:.4f} ms ({100 * rest_b / rest:.1f} % of it)")
    rows["color_convert"] = color_check(dev, hevc, cap, "encode")
    deblock_all_check(dev, hevc, db_log.calls, "the encode path")
    gp_all_check(dev, reconstruct, gp_log, "the encode path")
    recolor_all_check(dev, recolor, neighbors, rc_log, cfg, "the encode path")
    gs_all_check(dev, smoothing, gs_log, "the encode path")
    pp_all_check(dev, padding, l_log.calls, "the encode path (geometry and attribute planes)",
                 need_stack="shared")
    b_all_check(dev, hevc, b_log.calls, "the encode path", bs=32)
    del db_log, gp_log, rc_log, gs_log, l_log, b_log

    # 14. the attribute path on JAX's reconstruction rows
    recons = []
    real_rf = pipeline.reconstruct_frame

    def rf_spy(*a, **kw):
        out = real_rf(*a, **kw)
        recons.append(out)
        return out

    pipeline.reconstruct_frame = rf_spy
    try:
        Decoder(device="cuda").decode(FIXTURE.read_bytes())
    finally:
        pipeline.reconstruct_frame = real_rf
    bits = cfg.geometryBitDepth3D
    bad = []
    for i, (f, r, rec, e) in enumerate(zip(frames, ref["frames"], recons, enc0.last_encoded)):
        sp = torch.as_tensor(np.asarray(f.positions, np.int32), device=d)
        sc = torch.as_tensor(np.asarray(f.colors, np.uint8), device=d)
        col, _ = recolor.transfer_colors_compact(
            sp, sc, rec.pos, grid_bits=bits, k=cfg.numNeighborsColorTransferFwd,
            k_bwd=cfg.numNeighborsColorTransferBwd, max_geom_d2_fwd=cfg.maxGeometryDist2Fwd,
            max_geom_d2_bwd=cfg.maxGeometryDist2Bwd, max_color_d2_fwd=cfg.maxColorDist2Fwd,
            dist_offset_fwd=cfg.distOffsetFwd)
        got = {"points": int(rec.pos.shape[0]),
               "transfer_md5": array_md5(col.cpu().numpy(), "<i4")}
        col = smoothing.presmooth_colors(
            rec.pos, col, rec.bnd, bits, k=int(cfg.neighborCountColorPreSmoothing),
            radius2=float(cfg.radius2ColorPreSmoothing),
            thr_dist=float(cfg.thresholdColorPreSmoothing),
            thr_entropy=float(cfg.thresholdColorPreSmoothingLocalEntropy))
        got["presmooth_md5"] = array_md5(col.cpu().numpy(), "<i4")
        fr = e.geometry.front
        img0, img1 = enc0.attribute_images(rec, col, fr.frame.occupancy, fr.height, fr.width)
        got["t0_md5"] = array_md5(img0.cpu().numpy(), np.uint8)
        got["t1_md5"] = array_md5(img1.cpu().numpy(), np.uint8)
        bad += [f"frame {i} {k}" for k in got if got[k] != r[k]]
    if bad:
        raise AssertionError(f"attribute path on JAX's reconstruction differs: {bad}")
    print(f"attribute path on JAX's reconstruction: transferred and pre-smoothed colors, T0 and "
          f"T1 equal the JAX digests on all {n} frames (points "
          f"{[r['points'] for r in ref['frames']]}, pre-smoothing replaced "
          f"{[r['replaced'] for r in ref['frames']]})")

    # 15. the main path, counted and timed
    ref_parts = np.load(FRONT_PARTITIONS)
    enc = Encoder(cfg, device="cuda")
    padding.reset_inexact()
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lb_wrap, lb_name = lb_wrappers(padding, hevc)
    with Capture(e_wrap, rename=e_name, keep=False) as e_calls, \
            Capture({"sao": (hevc, "sao_search_apply")}, keep=False) as k_calls, \
            Capture(lb_wrap, rename=lb_name, keep=False) as lb_calls, \
            Capture(oq_wrappers(hevc), keep=False) as oq_calls, \
            Capture({"recolor": (recolor, "transfer_colors_compact"),
                     "grid_smooth": (smoothing, "grid_smooth")}, keep=False) as md_calls:
        segs1 = [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
            ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]
        stream, recon = enc.encode_gof(frames, segs=segs1)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dev.LAUNCHES)
    m_d_calls(launches, md_calls.counts, "the encode path", n,
              [("recolor", md_calls.counts["recolor"], 2)])
    one_a_call("sao", launches, k_calls.counts, "the encode path")
    lb_launch_check(launches, lb_calls.counts, "the encode path")
    oq_one_a_call(launches, oq_calls.counts, "the encode path")
    print_calls(oq_calls.counts, "the encode path (the encoder's own calls of kernels O and Q)",
                n)
    print(f"kernel E's calls on the encode path by k: {dict(e_calls.counts)}")
    if sum(e_calls.counts.values()) != launches["grid_knn"]:
        raise AssertionError(f"grid_knn: {launches['grid_knn']} launches for "
                             f"{sum(e_calls.counts.values())} calls")
    launches.update({name: e_calls.counts[name] for name in E_ENCODE_ROWS})
    inexact = padding.inexact_blocks()
    print(f"push-pull blocks reaching 2^24 where XLA's order is not established: {inexact}")
    if inexact:
        raise AssertionError(f"{inexact} push-pull blocks of unknown order reach 2^24")
    split = {f: sum(getattr(s, f) for s in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s", "video_s",
                       "reconstruct_s", "recolor_s")}
    print(f"warm encode: {dt:.3f}s for {n} frames = {dt / n:.4f} s/frame; per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"launches on the encode path: {launches}")
    idle = [k for k in ENCODER_PATH if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the encode path: {idle}")
    if stream != stream0:
        raise AssertionError("the warm encode's stream differs from the cold one's")
    trace = prof.trace_p_frame(enc, frames, enc.last_encoded, segs1)
    profiling.print_trace(*trace, "one warm P-frame of the whole encoder (frame 1, JAX "
                          "partitions)", top=16)
    e_items = [v for k, v in trace[2].items()
               if "grid_knn_kernel" in k or "grid_nearest_kernel" in k]
    print(f"kernel E in the P-frame trace: {sum(us for us, _ in e_items) / 1e3:.3f} ms in "
          f"{sum(c for _, c in e_items)} launches")
    for what, keys in (("kernel G", ("cc_init_kernel", "cc_hook_kernel", "cc_finalize_kernel")),
                       ("kernel G's hook", ("cc_hook_kernel",)), ("kernel K", ("sao_kernel",)),
                       ("kernel O", ("deblock_kernel",)), ("kernel Q", ("to_planes_", "to_rgb_"))):
        items = [v for k, v in trace[2].items() if any(x in k for x in keys)]
        print(f"{what} in the P-frame trace: {sum(us for us, _ in items) / 1e3:.3f} ms in "
              f"{sum(c for _, c in items)} launches")

    # the stream decodes to the encoder's reconstruction; RD against JAX
    dec = Decoder(device="cuda").decode(stream)
    if len(dec) != n:
        raise AssertionError(f"decoded {len(dec)} frames, expected {n}")
    for i, (a, b) in enumerate(zip(dec, recon)):
        if a.point_count != b.point_count or frame_digest(a.positions, a.colors) != \
                frame_digest(b.positions, b.colors):
            raise AssertionError(f"frame {i}: the decoded stream differs from the encoder's "
                                 "reconstruction")
        if not np.all(np.isfinite(b.positions)) or b.colors.shape != b.positions.shape:
            raise AssertionError(f"frame {i}: malformed reconstruction")
    print(f"the port's stream decodes exactly to the encoder's reconstruction on all {n} "
          f"frames (points {[b.point_count for b in recon]})")
    d_bytes = len(stream) / ref["stream_bytes"] - 1.0
    worst, rows_rd = 0.0, []
    for i, r in enumerate(ref["frames"]):
        for k, jp in enumerate(r["planes"]):
            pb, ps = planes[2 * i + k]
            worst = max(worst, abs(ps - jp["y_psnr"]))
            rows_rd.append(f"f{i}T{k} {pb}/{jp['bytes']} B {ps:.4f}/{jp['y_psnr']:.4f} dB")
    print("per attribute plane (port/JAX bytes, occupied luma PSNR): " + "; ".join(rows_rd))
    print("bytes per substream (port/JAX): " + ", ".join(
        f"{k} {enc.last_stream_stats.get(k)}/{v}" for k, v in ref["stream_stats"].items()))
    print(f"RD against the JAX encoder: stream {len(stream)} vs {ref['stream_bytes']} bytes "
          f"({100 * d_bytes:+.4f} %), worst attribute plane luma PSNR delta {worst:.4f} dB; "
          f"stream byte-identical to the fixture: {stream == FIXTURE.read_bytes()}")
    if abs(d_bytes) > RD_BYTES_TOL or worst > RD_PSNR_TOL_DB:
        raise AssertionError(f"RD gate: bytes {100 * d_bytes:+.3f} % (limit "
                             f"{100 * RD_BYTES_TOL} %), PSNR delta {worst:.3f} dB "
                             f"(limit {RD_PSNR_TOL_DB})")
    return rows, launches, (stream, recon)


def psnr_means(ms) -> dict:
    """Mean D1/D2/Y PSNRs of a list of FrameMetrics."""
    return {"d1_db": sum(m.c2c_psnr for m in ms) / len(ms),
            "d2_db": sum(m.c2p_psnr for m in ms) / len(ms),
            "y_db": sum(m.color_psnr[0] for m in ms) / len(ms)}


def metrics_phase(dev, cfg, frames, segs, decoded, r3):
    """Steps 16-19: kernel R, the fixture's metrics against JAX's and the
    r1/r3/r5 curve.  `decoded`: the port's decode of the fixture (step 5);
    `r3`: step 15's (stream, reconstruction).  Returns (rows, launches)."""
    import dataclasses

    import numpy as np

    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import metrics, neighbors

    ref = json.loads(RD_REFERENCE.read_text())
    d = torch.device("cuda")
    n = len(frames)
    src = [(torch.as_tensor(np.asarray(f.positions, np.int32), device=d),
            torch.as_tensor(f.colors, device=d)) for f in frames]

    def measure(recons, normals):
        return [metrics.compute_metrics(p, c, r.positions, r.colors, resolution=1023,
                                        src_normals=nrm, grid_bits=10, device=d)
                for (p, c), nrm, r in zip(src, normals, recons)]

    # 16. the metrics path on the fixture's decode, counted and timed
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    normals = [metrics.estimate_normals(p, 10, device=d) for p, _ in src]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = measure(decoded, normals)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(dev.LAUNCHES)
    print(f"metrics: source normals {(t1 - t0) / n:.4f} s/frame, compute_metrics "
          f"{(t2 - t1) / n:.4f} s/frame; launches {launches}")
    if launches["metrics"] != n:
        raise AssertionError(f"kernel R: {launches['metrics']} launches for {n} "
                             "compute_metrics calls (one a call)")
    worst = 0.0
    for i, (m, r) in enumerate(zip(got, ref["fixture"]["frames"])):
        if (m.c2c_mse, m.c2c_hausdorff, m.c2c_psnr) != \
                (r["c2c_mse"], r["c2c_hausdorff"], r["c2c_psnr"]):
            raise AssertionError(f"frame {i}: D1 MSE / Hausdorff {m.c2c_mse}/{m.c2c_hausdorff}, "
                                 f"JAX {r['c2c_mse']}/{r['c2c_hausdorff']}")
        pairs = [(m.c2p_psnr, r["c2p_psnr"])] + list(zip(m.color_psnr, r["color_psnr"]))
        if not all(np.isfinite(a) for a, _ in pairs):
            raise AssertionError(f"frame {i}: non-finite PSNR {m}")
        worst = max([worst] + [abs(a - b) for a, b in pairs])
    print(f"fixture metrics against the JAX package's on all {n} frames: D1 MSE and Hausdorff "
          f"equal, worst D2/Y/U/V PSNR delta {worst:.3g} dB (limit {METRICS_PSNR_TOL_DB}); "
          "D1 " + ", ".join(f"{m.c2c_psnr:.4f}" for m in got))
    if worst > METRICS_PSNR_TOL_DB:
        raise AssertionError(f"fixture metrics differ from JAX's by {worst} dB")

    # 17. kernel R's one launch == its plain version on frame 0's two directions
    p0, c0 = src[0]
    pb = torch.as_tensor(np.asarray(decoded[0].positions, np.int32), device=d)
    cb = torch.as_tensor(decoded[0].colors, device=d)
    nb = metrics.transfer_normals(p0, normals[0], pb, 10, device=d)
    misses = [int((neighbors.nearest(neighbors.build_grid(b, 10), a)[1]
                   >= neighbors.MAX_DIST2).sum()) for a, b in ((p0, pb), (pb, p0))]
    syncs = host_syncs(lambda: measure(decoded[:1], normals[:1]))
    print(f"metrics: frame 0's compute_metrics waits on the card {syncs} times (sync debug "
          f"mode \"warn\"); grid misses of its two directions {misses} (two reads when none)")
    (ia, da), (ib, db) = metrics._nearest_exact([(p0, pb), (pb, p0)], 10)
    dirs = [(p0, c0, pb, cb, nb, ia, da, p0.shape[0]),
            (pb, cb, p0, c0, normals[0], ib, db, pb.shape[0])]
    kern = lambda: metrics.metrics_reduce(dirs)
    plain = lambda: metrics.metrics_reduce_plain(dirs)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, :2], out_p[:, :2]):
        raise AssertionError(f"metrics: maximum d2 and D1 sum {out_k[:, :2].tolist()} vs plain "
                             f"{out_p[:, :2].tolist()}")
    fk, fp = out_k[:, 2:], out_p[:, 2:]
    err = float((fk - fp).abs().max())
    rel = float(((fk - fp).abs() / fp.abs().clamp(min=1e-300)).max())
    if rel > R_FLOAT_RTOL:
        raise AssertionError(f"metrics: float sums differ from the plain version by {rel:.3g} "
                             f"(relative; limit {R_FLOAT_RTOL})")
    if not all(torch.equal(kern(), out_k) for _ in range(5)):
        raise AssertionError("metrics: repeated launches differ")
    (k1, k2), (q1, q2) = time_turns(kern, plain)
    unit = time_ms(lambda: kern().cpu(), 20)
    b_ms, b_by = bounds("metrics", dirs, out_k)
    print(f"metrics: one launch for both directions; maximum d2 and D1 sum bit for bit "
          f"({out_k[:, :2].tolist()}), float64 sums max abs err {err:.3g} (relative {rel:.3g}), "
          f"5 repeats bit for bit; kernel {k1:.4f}/{k2:.4f} ms (device {graph_ms(kern):.4f} ms, "
          f"CUDA graph replay), with its host read {unit:.4f} ms, plain {q1:.3f}/{q2:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); rows {[a[7] for a in dirs]}, D1 windows "
          f"{[metrics.xla_windows(metrics.shape_bucket(a[7])) for a in dirs]}")
    rows = {"metrics": dict(ms=(k1 + k2) / 2, plain_ms=(q1 + q2) / 2, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err)}

    # 18. the RD curve at r1 / r3 / r5 against the JAX encoder's
    npts = sum(f.point_count for f in frames)
    curve = []
    for rate in ("r1", "r3", "r5"):
        jr = ref["rates"][rate]
        if rate == "r3":
            stream, recon = r3
        else:
            gqp, aqp = ref["rate_qps"][rate]
            t0 = time.perf_counter()
            enc = Encoder(dataclasses.replace(cfg, geometryQP=gqp, attributeQP=aqp),
                          device="cuda")
            stream, recon = enc.encode_gof(frames, segs=segs)
            torch.cuda.synchronize()
            print(f"{rate} encode (QP {gqp}/{aqp}, JAX partitions): "
                  f"{(time.perf_counter() - t0) / n:.4f} s/frame; bytes per substream "
                  "(port/JAX): " + ", ".join(f"{k} {enc.last_stream_stats.get(k)}/{v}"
                                             for k, v in jr["stream_stats"].items()))
        mean = psnr_means(measure(recon, normals))
        d_bytes = len(stream) / jr["stream_bytes"] - 1.0
        deltas = {k: mean[k] - jr["mean"][k] for k in mean}
        curve.append((rate, len(stream) * 8 / npts, jr["bpp"], mean, jr["mean"]))
        print(f"{rate}: stream {len(stream)} vs {jr['stream_bytes']} bytes "
              f"({100 * d_bytes:+.4f} %), byte-identical to the JAX encoder's: "
              f"{hashlib.md5(stream).hexdigest() == jr['stream_md5']}; mean PSNR deltas "
              + ", ".join(f"{k} {v:+.4f}" for k, v in deltas.items()))
        if abs(d_bytes) > RD_BYTES_TOL or max(abs(v) for v in deltas.values()) > RD_PSNR_TOL_DB:
            raise AssertionError(f"{rate} RD gate: bytes {100 * d_bytes:+.3f} % (limit "
                                 f"{100 * RD_BYTES_TOL} %), PSNR deltas {deltas} (limit "
                                 f"{RD_PSNR_TOL_DB} dB)")

    # 19. the curve
    print("RD curve, port / JAX (8 bench frames, JAX partitions; bpp, mean D1, D2, Y dB):")
    for rate, bpp, jbpp, m, jm in curve:
        print(f"  {rate}: bpp {bpp:.4f}/{jbpp:.4f}  D1 {m['d1_db']:.4f}/{jm['d1_db']:.4f}  "
              f"D2 {m['d2_db']:.4f}/{jm['d2_db']:.4f}  Y {m['y_db']:.4f}/{jm['y_db']:.4f}")
    return rows, launches


def blend_inputs(recolor, neighbors, args, kw):
    """The inputs of kernel M's blend entry on one vox11 transfer
    (`transfer_colors`' source positions and colors, targets, host exact
    matches), with its two sweeps (kernel E, unpacked table) run once, as
    `transfer_colors` runs them: (src_col, idx, d2 of every target, tidx
    and td2 of every source, exact_idx, has_exact)."""
    src_pos, src_col, tgt, exact_idx, has_exact = args[:5]
    bits = kw["grid_bits"]
    idx, d2 = neighbors.knn(neighbors.build_grid(src_pos, bits), tgt, k=kw["k"], bucket=6)
    tidx, td2 = neighbors.nearest(neighbors.build_grid(tgt, bits), src_pos, bucket=6)
    return src_col.to(torch.uint8).contiguous(), idx, d2, tidx, td2, exact_idx, has_exact


def blend_entries(recolor, inputs, kw, plain: bool):
    """Kernel M's blend entry (or its plain version) over every target and
    every source, the sources of exact targets dropped, on `blend_inputs`."""
    src_col, idx, d2, tidx, td2, eidx, has = inputs
    sfx = "_plain" if plain else ""
    return getattr(recolor, "blend_merge" + sfx)(
        src_col, eidx, has, None, idx, d2, None, tidx, td2, float(kw["max_geom_d2_fwd"]),
        float(kw["max_color_d2_fwd"]), float(kw["dist_offset_fwd"]), float(kw["max_geom_d2_bwd"]))


def blend_all_check(dev, recolor, neighbors, log, where: str) -> None:
    """Kernel M's blend entry against its plain version on every
    `transfer_colors` call `log` (a CallLog) kept, bit for bit, one launch
    a call; the largest once under sync debug mode "error" (the whole
    transfer), its call and device times."""
    calls = list(zip(log.calls, log.kws))
    if not calls:
        raise AssertionError(f"transfer_colors: no call captured on {where}")
    for i, (a, kw) in enumerate(calls):
        m_in = blend_inputs(recolor, neighbors, a, kw)
        torch.cuda.synchronize()
        before = dev.LAUNCHES["recolor"]
        got = blend_entries(recolor, m_in, kw, plain=False)
        launches = dev.LAUNCHES["recolor"] - before
        if launches != 1 or not torch.equal(got, blend_entries(recolor, m_in, kw, plain=True)):
            raise AssertionError(f"recolor_blend call {i} on {where}: {launches} launches, "
                                 "kernel differs from its plain version")
    a, kw = max(calls, key=lambda c: c[0][2].shape[0])
    m_in = blend_inputs(recolor, neighbors, a, kw)
    fn = lambda: blend_entries(recolor, m_in, kw, plain=False)
    if no_sync_launches(dev, "recolor", lambda: recolor.transfer_colors(*a, **kw)) != 1:
        raise AssertionError(f"transfer_colors on {where}: expected one launch of kernel M")
    print(f"recolor_blend: all {len(calls)} captured transfer_colors calls of {where} exact, "
          "one launch a call; the largest transfer: no host synchronisation (sync debug mode "
          f"\"error\"); the entry: call {time_ms(fn, 5):.4f} ms, device {device_ms(fn):.4f} "
          "ms (torch.profiler)")


def vox11_phase(dev):
    """Steps 21-26: the vox11 path (kernel E's unpacked table, the
    full-graph CC round on kernel G, kernel M's uncompacted blend) on two
    full-size 11-bit frames.  Returns (rows, launches, the frames)."""
    import dataclasses

    import numpy as np

    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import cc, metrics, neighbors, recolor, smoothing
    from vpcc_tpu_torch.utils.checksum import array_md5, patches_md5
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads(VOX11_REFERENCE.read_text())
    ref_parts = np.load(VOX11_PARTITIONS)
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    bits = cfg.geometryBitDepth3D
    d = torch.device("cuda")

    # 21. the frames
    t0 = time.perf_counter()
    frames = [make_person_cloud(bits=bits, n_samples=ref["n_samples"], seed=s)
              for s in ref["seeds"]]
    if [f.point_count for f in frames] != ref["source_points"]:
        raise AssertionError("vox11 frames differ from the JAX package's")
    n = len(frames)
    print(f"vox11: {n} frames made in {time.perf_counter() - t0:.1f}s, points "
          f"{[f.point_count for f in frames]}")

    def driven_segs(enc):
        return [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
            ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]

    # 22. warm-up with the JAX partitions, capturing each entry's largest call
    wrappers = {"grid_knn_xyz": (neighbors, "knn"), "cc_round_voxel": (cc, "cc_round_voxel"),
                "recolor_blend": (recolor, "transfer_colors"),
                "grid_smooth": (smoothing, "grid_smooth")}
    t0 = time.perf_counter()
    with Capture(wrappers) as cap, CallLog(recolor, "transfer_colors") as tc_log, \
            CallLog(smoothing, "grid_smooth") as gs_log:
        enc = Encoder(cfg, device="cuda")
        enc.encode_gof(frames, segs=driven_segs(enc))
        torch.cuda.synchronize()
    print(f"vox11 cold encode: {(time.perf_counter() - t0) / n:.3f} s/frame")
    print_calls(cap.counts, "the vox11 path", n)
    missing = sorted(set(wrappers) - set(cap.calls))
    if missing:
        raise AssertionError(f"vox11: entries never called: {missing}")

    # 23. each entry == its plain version on the card, timed in turns
    _, (kg, kq), kkw = cap.calls["grid_knn_xyz"]
    if kg.packed:
        raise AssertionError("vox11: the k-NN grid is packed")
    _, cc_args, _ = cap.calls["cc_round_voxel"]
    _, rc_args, rc_kw = cap.calls["recolor_blend"]
    m_in = blend_inputs(recolor, neighbors, rc_args, rc_kw)
    checks = {
        "grid_knn_xyz": (lambda: neighbors.knn(kg, kq, **kkw),
                         lambda: neighbors.knn_plain(kg, kq, **kkw),
                         (kg, kq, 3 * kkw["bucket"])),
        "cc_round_voxel": (lambda: cc.cc_round_voxel(*cc_args),
                           lambda: cc.cc_round_voxel_plain(*cc_args), cc_args),
        "recolor_blend": (lambda: blend_entries(recolor, m_in, rc_kw, plain=False),
                          lambda: blend_entries(recolor, m_in, rc_kw, plain=True), m_in),
    }
    rows = {}
    for name, (kern, plain, args) in checks.items():
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(tuple(out_k), tuple(out_p)) if isinstance(out_k, tuple) \
            else max_abs_err(out_k, out_p)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        (k1, k2), (p1, p2) = time_turns(kern, plain, reps_k=5, reps_p=2)
        b_ms, b_by = bounds(name, args, out_k)
        shapes = [tuple(a.shape) for a in (rc_args[:3] if name == "recolor_blend" else args)
                  if torch.is_tensor(a)]
        print(f"{name} (vox11): exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}); inputs {shapes}"
              + (f", k={kkw['k']} bucket={kkw['bucket']}" if name == "grid_knn_xyz" else ""))
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err, library_ms=None)
    blend_all_check(dev, recolor, neighbors, tc_log, "the vox11 path")
    gs_all_check(dev, smoothing, gs_log, "the vox11 path")
    del tc_log, gs_log

    # 24. the main path, counted and timed; the spies keep each stage's
    # digest for the checks afterwards
    seen = [dict(cc_rounds_md5=[]) for _ in frames]
    state = {"seg": -1, "frame": -1, "in_seg": False}
    real = {"knn": neighbors.knn, "round": cc.cc_round_voxel, "tc": recolor.transfer_colors,
            "ps": smoothing.presmooth_colors, "gen": Encoder.generate_patches,
            "seg": Encoder.segment_dispatch, "front": Encoder.encode_frame_front}

    def knn_spy(*a, **kw):
        out = real["knn"](*a, **kw)
        if state["in_seg"]:
            seen[state["seg"]]["knn"] = (array_md5(out[0].cpu().numpy(), "<i4"),
                                         array_md5(out[1].cpu().numpy(), "<i4"))
        return out

    def seg_spy(self, pc):
        state["seg"] += 1
        state["in_seg"] = True
        try:
            return real["seg"](self, pc)
        finally:
            state["in_seg"] = False

    def front_spy(self, *a, **kw):
        state["frame"] += 1
        return real["front"](self, *a, **kw)

    def round_spy(*a):
        out = real["round"](*a)
        lab = out.cpu().numpy()
        seen[state["frame"]]["cc_rounds_md5"].append(
            array_md5(np.where(lab >= a[0].shape[0], -1, lab), "<i4"))
        return out

    def gen_spy(self, *a):
        patches, dist2 = real["gen"](self, *a)
        seen[state["frame"]].update(patches=len(patches), patches_md5=patches_md5(patches),
                                    dist2_md5=array_md5(dist2, "<f8"))
        return patches, dist2

    def tc_spy(*a, **kw):
        out = real["tc"](*a, **kw)
        seen[state["frame"]]["transfer_md5"] = array_md5(out.cpu().numpy(), "<i4")
        return out

    def ps_spy(*a, **kw):
        out = real["ps"](*a, **kw)
        seen[state["frame"]]["presmooth_md5"] = array_md5(out.cpu().numpy(), "<i4")
        return out

    patched = [(neighbors, "knn", knn_spy), (cc, "cc_round_voxel", round_spy),
               (recolor, "transfer_colors", tc_spy), (smoothing, "presmooth_colors", ps_spy),
               (Encoder, "generate_patches", gen_spy), (Encoder, "segment_dispatch", seg_spy),
               (Encoder, "encode_frame_front", front_spy)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, fn in patched:
        setattr(obj, name, fn)
    try:
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Capture({"grid_smooth": (smoothing, "grid_smooth"),
                      "tc": (recolor, "transfer_colors")}, keep=False) as md_calls:
            enc = Encoder(cfg, device="cuda")
            stream, recon = enc.encode_gof(frames, segs=driven_segs(enc))
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(dev.LAUNCHES)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    m_d_calls(launches, md_calls.counts, "the vox11 path", n,
              [("recolor", md_calls.counts["tc"], 1)])
    split = {f: sum(getattr(st, f) for st in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s", "video_s",
                       "reconstruct_s", "recolor_s")}
    print(f"vox11 warm encode: {dt / n:.4f} s/frame (JAX partitions); per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"vox11 launches on the encode path: {launches}")
    idle = [k for k, c in VOX11_ROWS.items() if launches.get(c, 0) == 0]
    if idle:
        raise AssertionError(f"vox11: entries not launched on the encode path: {idle}")

    # 25. the stages, the stream and its decode against the JAX package's
    bad = []
    for i, (got, r) in enumerate(zip(seen, ref["frames"])):
        if got["knn"] != (r["knn_idx_md5"], r["knn_d2_md5"]):
            bad.append(f"frame {i} voxel k-NN")
        for key in ("cc_rounds_md5", "patches", "patches_md5", "dist2_md5", "transfer_md5",
                    "presmooth_md5"):
            if got.get(key) != r[key]:
                bad.append(f"frame {i} {key}")
        rc = recon[i]
        if (rc.point_count, frame_digest(rc.positions, rc.colors)) != \
                (r["recon_points"], r["recon_md5"]):
            bad.append(f"frame {i} reconstruction")
        if not np.all(np.isfinite(rc.positions)) or rc.colors.shape != rc.positions.shape:
            raise AssertionError(f"vox11 frame {i}: malformed reconstruction")
    if bad:
        raise AssertionError(f"vox11 stages differ from the JAX digests: {bad}")
    print(f"vox11 stages against the JAX package (voxel k-NN, CC rounds "
          f"{[len(g['cc_rounds_md5']) for g in seen]}, patches {[g['patches'] for g in seen]}, "
          "coverage dist2, recolor, pre-smoothing, reconstruction): all equal")
    print("vox11 bytes per substream (port/JAX): " + ", ".join(
        f"{k} {enc.last_stream_stats.get(k)}/{v}" for k, v in ref["stream_stats"].items()))
    same_stream = hashlib.md5(stream).hexdigest() == ref["stream_md5"]
    d_bytes = len(stream) / ref["stream_bytes"] - 1.0
    print(f"vox11 stream {len(stream)} vs {ref['stream_bytes']} bytes ({100 * d_bytes:+.4f} %), "
          f"byte-identical to the JAX encoder's: {same_stream}")
    if not same_stream:
        raise AssertionError("vox11: the stream differs from the JAX encoder's")
    t0 = time.perf_counter()
    dec = Decoder(device="cuda").decode(stream)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n
    for i, (a, b) in enumerate(zip(dec, recon)):
        if a.point_count != b.point_count or frame_digest(a.positions, a.colors) != \
                frame_digest(b.positions, b.colors):
            raise AssertionError(f"vox11 frame {i}: the decoded stream differs from the "
                                 "encoder's reconstruction")
    print(f"vox11 decode: {t_dec:.4f} s/frame; the port's stream decodes exactly to the "
          f"encoder's reconstruction (points {[b.point_count for b in recon]})")

    # 26. the metrics against the JAX package's
    t0 = time.perf_counter()
    got_m = []
    for f, rc in zip(frames, recon):
        p = torch.as_tensor(np.asarray(f.positions, np.int32), device=d)
        c = torch.as_tensor(f.colors, device=d)
        nrm = metrics.estimate_normals(p, bits, device=d)
        got_m.append(metrics.compute_metrics(p, c, rc.positions, rc.colors,
                                             resolution=(1 << bits) - 1, src_normals=nrm,
                                             grid_bits=bits, device=d))
    torch.cuda.synchronize()
    t_met = (time.perf_counter() - t0) / n
    worst, ulps = 0.0, []
    for i, (m, r) in enumerate(zip(got_m, ref["frames"])):
        jm = r["metrics"]
        pairs = [(m.c2c_psnr, jm["c2c_psnr"]), (m.c2p_psnr, jm["c2p_psnr"])] + \
            list(zip(m.color_psnr, jm["color_psnr"]))
        if not all(np.isfinite(a) for a, _ in pairs):
            raise AssertionError(f"vox11 frame {i}: non-finite PSNR {m}")
        worst = max([worst] + [abs(a - b) for a, b in pairs])
        # both sum the per-point float32 d2 in XLA's CPU reduce order, which
        # rounds once the sum passes 2^24 (~20 per point here; ROADMAP F7)
        ulps.append(abs(m.c2c_mse - jm["c2c_mse"]) / float(np.spacing(np.float32(jm["c2c_mse"]))))
        if m.c2c_hausdorff != jm["c2c_hausdorff"] or ulps[-1] > VOX11_D1_MSE_ULPS:
            raise AssertionError(f"vox11 frame {i}: D1 MSE / Hausdorff {m.c2c_mse}/"
                                 f"{m.c2c_hausdorff}, JAX {jm['c2c_mse']}/{jm['c2c_hausdorff']}")
    print(f"vox11 compute_metrics: {t_met:.4f} s/frame (with source normals); D1 "
          + ", ".join(f"{m.c2c_psnr:.4f}" for m in got_m) + "; Hausdorff equal to JAX's, D1 MSE "
          f"within {[round(u, 2) for u in ulps]} float32 ulps of JAX's; worst D1/D2/Y/U/V PSNR "
          f"delta {worst:.3g} dB")
    if worst > METRICS_PSNR_TOL_DB:
        raise AssertionError(f"vox11 metrics differ from JAX's by {worst} dB "
                             f"(limit {METRICS_PSNR_TOL_DB})")
    return rows, launches, frames


def inter_pixels16(split, modes) -> int:
    """Samples of kernel A's two-level planes whose decoded mode is inter
    (the only samples for which it reads `ref`)."""
    from vpcc_tpu_torch.video.hevc_tables import MODE_INTER

    whole = ((split == 0) & (modes[..., 0] == MODE_INTER)).sum() * 256
    sub8 = ((split != 0)[..., None] & (modes == MODE_INTER)).sum() * 64
    return int(whole + sub8)


def geo11_phase(dev, frames):
    """Steps 52-57: the two-level (16/8) codec (kernel I's and kernel A's
    two-level entries; J and B at 16-px CUs, K at 16-px regions, L on
    11-bit planes) on the two vox11 frames at geometryNominal2dBitdepth=11,
    and the video_codec app.  Returns (rows, launches)."""
    import tempfile

    import numpy as np

    from vpcc_tpu_torch.apps import video_codec
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import metrics, padding
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.video import codecs, hevc

    ref = json.loads(GEO11_REFERENCE.read_text())
    ref_parts = np.load(VOX11_PARTITIONS)
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    if [f.point_count for f in frames] != ref["source_points"]:
        raise AssertionError("geo11: the vox11 frames differ from the reference's")
    n = len(frames)
    d = torch.device("cuda")

    # 52. the main path, counted: encode_gof driven by the JAX partitions,
    # keeping the largest call of kernel I's two-level entry and of the
    # plane dispatch, and counting the geometry samples above 1023
    above = []
    real_geo = codecs.GeometrySubstreamEncoder.encode

    def geo_spy(self, geo, occ=None, **kw):
        g = np.asarray(geo)
        above.append((int((g > 1023).sum()), int(((g > 1023) & (np.asarray(occ) != 0)).sum())))
        return real_geo(self, geo, occ=occ, **kw)

    lb_wrap, lb_name = lb_wrappers(padding, hevc)
    wrappers = {"wavefront_encode16": (hevc, "wavefront_encode16"),
                "dispatch": (hevc, "encode_planes_dispatch"),
                "sao": (hevc, "sao_search_apply"), **lb_wrap}
    by_region = lambda a, kw: f"sao{kw.get('region', 32)}"
    codecs.GeometrySubstreamEncoder.encode = geo_spy
    try:
        with Capture(wrappers, rename={"sao": by_region, **lb_name}) as cap, \
                CallLog(hevc, "motion_search") as j_calls, \
                CallLog(padding, "push_pull_round") as l_log, \
                CallLog(hevc, "half_pel_mc") as b_log:
            padding.reset_inexact()
            dev.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = Encoder(cfg, device="cuda")
            segs = [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
                ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]
            stream, recon = enc.encode_gof(frames, segs=segs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(dev.LAUNCHES)
            inexact = padding.inexact_blocks()
    finally:
        codecs.GeometrySubstreamEncoder.encode = real_geo
    split = {f: sum(getattr(st, f) for st in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s", "video_s",
                       "reconstruct_s", "recolor_s")}
    print(f"geo11 encode (the run's first two-level GOF): {dt / n:.4f} s/frame (JAX "
          "partitions); per frame " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"geo11 launches on the encode path: { {k: v for k, v in launches.items() if v} }")
    # (J and B run where a P-frame keeps its parent's atlas shape; step 54's
    # P-plane runs them in any case)
    idle = [k for k in ("wavefront_encode16", "sao", "push_pull") if launches[k] == 0]
    if idle:
        raise AssertionError(f"geo11: not launched on the encode path: {idle}")
    one_a_call("sao", launches, {"sao": cap.counts["sao16"] + cap.counts["sao32"]},
               "the geo11 encode")
    lb_launch_check(launches, cap.counts, "the geo11 encode")
    pp_all_check(dev, padding, l_log.calls, "the geo11 encode (11-bit planes)")
    b_calls = b_log.calls
    del l_log, b_log
    sao_check(hevc, *cap.calls["sao16"][1:], "the geo11 encode")
    print(f"geo11 geometry samples above 1023 per plane (all, occupied): {above} "
          f"(JAX: {[list(zip(f['above_1023'], f['above_1023_occupied'])) for f in ref['frames']]})")
    print(f"geo11 push-pull blocks reaching 2^24 where XLA's order is not established: {inexact}")
    if inexact:
        raise AssertionError("geo11: push-pull blocks of unknown order reached 2^24")
    flags = [[p[1 + 5] for p in e.geometry_payloads] for e in enc.last_encoded]
    if flags != [f["geo_flags"] for f in ref["frames"]] or any(
            not fl & hevc.FLAG_SAO16 or fl & hevc.FLAG_CU32 for fr in flags for fl in fr):
        raise AssertionError(f"geo11: geometry payload flags {flags}, JAX "
                             f"{[f['geo_flags'] for f in ref['frames']]}")

    # 53. the stream against the JAX encoder's, its decode
    same = hashlib.md5(stream).hexdigest() == ref["stream_md5"]
    geo_same = [[hashlib.md5(p).hexdigest() == m for p, m in zip(e.geometry_payloads, f["geo_md5"])]
                for e, f in zip(enc.last_encoded, ref["frames"])]
    d_bytes = len(stream) / ref["stream_bytes"] - 1.0
    print(f"geo11 stream {len(stream)} vs {ref['stream_bytes']} bytes ({100 * d_bytes:+.4f} %), "
          f"byte-identical to the JAX encoder's: {same}; geometry payloads identical per frame "
          f"(D0, D1): {geo_same}; bytes per substream (port/JAX): " + ", ".join(
              f"{k} {enc.last_stream_stats.get(k)}/{v}" for k, v in ref["stream_stats"].items()))
    for i, (rc, r) in enumerate(zip(recon, ref["frames"])):
        if not np.all(np.isfinite(rc.positions)) or rc.colors.shape != rc.positions.shape:
            raise AssertionError(f"geo11 frame {i}: malformed reconstruction")
        if same and (rc.point_count, frame_digest(rc.positions, rc.colors)) != \
                (r["recon_points"], r["recon_md5"]):
            raise AssertionError(f"geo11 frame {i}: the reconstruction differs from JAX's")
    if not same:
        # the RD gate: bytes and mean D1/D2/Y against the JAX encoder's
        got = []
        for f, rc in zip(frames, recon):
            p = torch.as_tensor(np.asarray(f.positions, np.int32), device=d)
            nrm = metrics.estimate_normals(p, 11, device=d)
            got.append(metrics.compute_metrics(p, torch.as_tensor(f.colors, device=d),
                                               rc.positions, rc.colors, resolution=2047,
                                               src_normals=nrm, grid_bits=11, device=d))
        mean = {"d1": float(np.mean([m.c2c_psnr for m in got])),
                "d2": float(np.mean([m.c2p_psnr for m in got])),
                "y": float(np.mean([m.color_psnr[0] for m in got]))}
        worst = max(abs(mean[k] - ref["mean"][k]) for k in mean)
        print(f"geo11 RD against the JAX encoder's: bytes {100 * d_bytes:+.4f} %, mean "
              f"D1/D2/Y {mean} vs {ref['mean']} (worst {worst:.4f} dB)")
        if abs(d_bytes) > RD_BYTES_TOL or worst > RD_PSNR_TOL_DB:
            raise AssertionError("geo11: the stream fails the RD gate against JAX's")
    wrap16 = {"wavefront_decode16": (hevc, "wavefront_decode16")}
    with Capture({**wrap16, "sao_apply": (hevc, "sao_apply")},
                 rename={"sao_apply": lambda a, kw: f"sao_apply{kw.get('region', 32)}"}) as dcap:
        _, t_dec, dec_launches = decode_checked(dev, stream, recon, "geo11")
    _, a16, kw16 = dcap.calls["sao_apply16"]
    err = max_abs_err(hevc.sao_apply(*a16, **kw16), hevc.sao_apply_plain(*a16, **kw16))
    if err:
        raise AssertionError(f"geo11: sao_apply at 16-px regions differs from its plain "
                             f"version (max abs err {err})")
    print(f"geo11 decode's sao_apply at 16-px regions (planes {tuple(a16[0].shape)}): exact; "
          f"device {graph_ms(lambda: hevc.sao_apply(*a16, **kw16)):.4f} ms a call (CUDA graph "
          "replay)")
    print(f"geo11 decode: {t_dec:.4f} s/frame; the port's stream decodes exactly to the "
          f"encoder's reconstruction (points {[b.point_count for b in recon]})")
    if not dec_launches.get("wavefront_decode16"):
        raise AssertionError("geo11: kernel A's two-level entry not launched on the decode")

    # 54. kernel I's and kernel A's two-level entries against their plain
    # versions: the GOF's largest call, a motion-searched P-plane of that
    # content (the decoded plane shifted by (3, -2) as its reference) and a
    # crafted 1280x1280 random-walk plane spanning 0..2047
    enc_calls = {"gof": cap.calls["wavefront_encode16"][1]}
    dec_calls = {"gof": dcap.calls["wavefront_decode16"][1]}
    planes, qps, maxvals = cap.calls["dispatch"][1][:3]
    kw = cap.calls["dispatch"][2]
    rng = np.random.default_rng(2047)
    walk = np.clip(np.cumsum(rng.integers(-40, 41, (1, 1280, 1280)), axis=2) + 1024, 0, 2047)
    base = hevc.encode_planes_dispatch(planes, qps, maxvals, occ=kw.get("occ"),
                                       weight=kw.get("weight"), deblock=False)
    p_ref = torch.roll(base.rec, (3, -2), (1, 2)).contiguous()
    extra = {
        "P-plane": (lambda: hevc.encode_planes_dispatch(
            planes, qps, maxvals, refs=p_ref, occ=kw.get("occ"), weight=kw.get("weight"),
            deblock=False, motion=True), p_ref),
        "random walk": (lambda: hevc.encode_planes_dispatch(
            torch.as_tensor(walk.astype(np.int32), device=d), [24], [2047], deblock=False),
            None),
    }
    for name, (run, refs) in extra.items():
        with Capture({"wavefront_encode16": (hevc, "wavefront_encode16")}) as c1, \
                CallLog(hevc, "motion_search") as j1, CallLog(hevc, "half_pel_mc") as b1:
            coded = run()
        j_calls.calls += j1.calls
        b_calls += b1.calls
        with Capture(wrap16) as c2, CallLog(hevc, "half_pel_mc") as b2:
            got = hevc.decode_planes(coded.payload(), refs=refs, device=d)
        b_calls += b2.calls
        torch.cuda.synchronize()
        if not torch.equal(got, coded.rec):
            raise AssertionError(f"geo11 {name}: the decode differs from the encoder's planes")
        enc_calls[name] = c1.calls["wavefront_encode16"][1]
        dec_calls[name] = c2.calls["wavefront_decode16"][1]
    print(f"geo11 P-plane: {int((enc_calls['P-plane'][4] > 0).sum())} of "
          f"{enc_calls['P-plane'][4].numel()} CUs with an MV rate")
    # kernel J at 16-px CUs: every call of the GOF and of the P-plane, and
    # the largest one timed
    motion_all_check(hevc, j_calls.calls, "the geo11 encode and its P-plane")
    b_all_check(dev, hevc, b_calls, "the geo11 encode and its P-plane (encode and decode)",
                bs=16)
    del b_calls
    ms16 = max(j_calls.calls, key=lambda a: a[0].numel())
    (k1, k2), (p1, p2) = time_turns(lambda: hevc.motion_search(*ms16),
                                    lambda: hevc.motion_search_plain(*ms16))
    b_ms, b_by = bounds("motion_search", ms16, hevc.motion_search(*ms16))
    print(f"motion_search at 16-px CUs ({tuple(ms16[0].shape)}): kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    del j_calls
    rows = {}
    for name, fn, plain, calls in (
            ("wavefront_encode16", hevc.wavefront_encode16, hevc.wavefront_encode16_plain,
             enc_calls),
            ("wavefront_decode16", hevc.wavefront_decode16, hevc.wavefront_decode16_plain,
             dec_calls)):
        for which, args in calls.items():
            out_k = fn(*args)
            out_p, p_ms = timed(lambda: plain(*args))
            torch.cuda.synchronize()
            err = max_abs_err(tuple(out_k), tuple(out_p)) if isinstance(out_k, tuple) \
                else max_abs_err(out_k, out_p)
            if err != 0:
                raise AssertionError(f"{name} ({which}): kernel differs from its plain version "
                                     f"(max abs err {err})")
            if which == "gof":
                k1, k2 = time_ms(lambda: fn(*args), 5), time_ms(lambda: fn(*args), 5)
                b_ms, b_by = bounds(name, args, out_k)
                rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, max_abs_err=err, library_ms=None)
                timing = (f"kernel {k1:.4f}/{k2:.4f} ms, plain {p_ms:.3f} ms (one run), bound "
                          f"{b_ms:.4f} ms ({b_by}); ")
            else:
                timing = ""
            print(f"{name} ({which}): exact (max abs err {err}); {timing}inputs "
                  f"{[tuple(t.shape) for t in args if torch.is_tensor(t)][:2]}")

    # 55. the video_codec app on the card: three 11-bit depth frames
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        f0 = np.clip(np.cumsum(rng.integers(-40, 41, (256, 256)), axis=1) + 1024, 0, 2047)
        vids = np.stack([np.roll(f0, (2 * i, i), (0, 1)) for i in range(3)]).astype(np.uint16)
        np.save(tmp / "in.npy", vids)
        opts = ["--qp=24", "--geometryNominal2dBitdepth=11", "--device=cuda"]
        if video_codec.main(["encode", str(tmp / "in.npy"), str(tmp / "v.bin")] + opts) or \
                video_codec.main(["decode", str(tmp / "v.bin"), str(tmp / "rec.npy")] + opts):
            raise AssertionError("video_codec app failed")
        got = np.load(tmp / "rec.npy")
        nbytes_app = (tmp / "v.bin").stat().st_size
    gcfg = VPCCConfig()
    gcfg.geometryNominal2dBitdepth, gcfg.geometryQP = 11, 24
    genc = codecs.GeometrySubstreamEncoder(gcfg, d)
    want = np.stack([genc.encode(f)[1].cpu().numpy() for f in vids])
    if not np.array_equal(got, want):
        raise AssertionError("video_codec app: the decode differs from the encoder's planes")
    print(f"video_codec app: 3 frames of 256x256 at 11 bits ({int((vids > 1023).sum())} samples "
          f"above 1023), {nbytes_app} bytes; the decode equals the encoder's reconstruction")
    return rows, {"wavefront_encode16": launches["wavefront_encode16"],
                  "wavefront_decode16": dec_launches["wavefront_decode16"]}


def unit_bytes(stream: bytes) -> dict:
    """Bytes of each V3C unit's payload by type and, for the video
    substreams, map index (as tests/torch_make_lossless_reference.py counts
    them)."""
    from vpcc_tpu_torch.bitstream import v3c
    from vpcc_tpu_torch.bitstream.bitio import BitReader

    names = {v3c.V3C_VPS: "VPS", v3c.V3C_AD: "AD", v3c.V3C_OVD: "OVD", v3c.V3C_GVD: "GVD",
             v3c.V3C_AVD: "AVD"}
    out = {}
    for utype, payload in v3c.read_sample_stream(stream):
        key = names[utype]
        if utype in (v3c.V3C_OVD, v3c.V3C_GVD, v3c.V3C_AVD):
            key += f" {v3c.VideoSubstream.read(BitReader(payload)).map_index}"
        out[key] = out.get(key, 0) + len(payload)
    return out


def decode_checked(dev, stream, recon, what):
    """Decodes `stream` with the port's decoder, counters at 0 before, and
    requires every frame to equal `recon`.  Returns (frames, seconds per
    frame, the decode path's launches).  Kernel A's entries must launch
    once a call."""
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.video import hevc

    entries = ("wavefront_decode32", "wavefront_decode16")
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture({k: (hevc, k) for k in entries}, keep=False) as calls:
        dec = Decoder(device="cuda").decode(stream)
        torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / len(recon)
    launches = {k: v for k, v in dev.LAUNCHES.items() if v}
    print(f"{what} launches on the decode path: {launches}")
    for name in entries:
        if calls.counts[name] or launches.get(name):
            one_a_call(name, launches, calls.counts, f"the {what} decode")
    for i, (a, b) in enumerate(zip(dec, recon)):
        if a.point_count != b.point_count or frame_digest(a.positions, a.colors) != \
                frame_digest(b.positions, b.colors):
            raise AssertionError(f"{what} frame {i}: the decoded stream differs from the "
                                 "encoder's reconstruction")
    return dec, t_dec, launches


def encode_driven(cfg, frames):
    """`Encoder(cfg, device="cuda").encode_gof` driven by the committed JAX
    partitions: (encoder, stream, reconstructions)."""
    import numpy as np

    from vpcc_tpu_torch.encoder import Encoder

    ref_parts = np.load(FRONT_PARTITIONS)
    enc = Encoder(cfg, device="cuda")
    segs = [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
        ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]
    return enc, *enc.encode_gof(frames, segs=segs)


def lossless_phase(dev, frames):
    """Steps 28-32: the CTC's lossless conditions (raw points, EOM, the
    lossless video, the RAW/EOM aux substreams) on the first four bench
    frames, and EOM under r3 on the first two.  Returns (rows, launches)."""
    import zlib

    import numpy as np

    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.ops import reconstruct
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.video import codecs

    ref = json.loads(LOSSLESS_REFERENCE.read_text())

    def config(name):
        cfg = VPCCConfig()
        for k, v in ref["configs"][name]["overrides"].items():
            setattr(cfg, k, v)
        return cfg

    encode = encode_driven

    rl = ref["configs"]["lossless"]
    cfg = config("lossless")
    fr = frames[:len(rl["seeds"])]
    n = len(fr)
    if [f.point_count for f in fr] != [r["source_points"] for r in rl["frames"]]:
        raise AssertionError("lossless: the frames differ from the JAX package's")

    # 28. warm-up, capturing the largest call of kernel C's EOM entry and of
    # kernel S's two operations
    wrappers = {"generate_points_eom": (reconstruct, "generate_points"),
                "eom_extract": (pipeline, "extract_eom_colors"),
                "eom_inject": (pipeline, "inject_eom_colors")}
    t0 = time.perf_counter()
    with Capture(wrappers) as cap, CallLog(reconstruct, "generate_points") as gp_log:
        encode(cfg, fr)
        torch.cuda.synchronize()
    print(f"lossless cold encode: {(time.perf_counter() - t0) / n:.4f} s/frame")
    gp_all_check(dev, reconstruct, gp_log, "the lossless encode (EOM)")
    del gp_log
    missing = sorted(set(wrappers) - set(cap.calls))
    if missing:
        raise AssertionError(f"lossless: never called: {missing}")
    _, gp_args, gp_kw = cap.calls["generate_points_eom"]
    if gp_kw.get("eom") is None:
        raise AssertionError("lossless: kernel C ran without an EOM plane")
    _, ex_args, _ = cap.calls["eom_extract"]
    _, in_args, _ = cap.calls["eom_inject"]

    # 29. kernel C's EOM entry and kernel S == their plain versions, timed in
    # three rounds of turns
    gp_k = lambda: tuple(reconstruct.generate_points(*gp_args, **gp_kw))
    gp_p = lambda: tuple(reconstruct.generate_points_plain(*gp_args, **gp_kw))
    s_k = lambda: (pipeline.extract_eom_colors(*ex_args), pipeline.inject_eom_colors(*in_args))
    s_p = lambda: (pipeline.extract_eom_colors_plain(*ex_args),
                   pipeline.inject_eom_colors_plain(*in_args))
    rows = {}
    for name, k_fn, p_fn, args in (("generate_points_eom", gp_k, gp_p, (gp_args, gp_kw)),
                                   ("eom_colors", s_k, s_p, (ex_args, in_args))):
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        turns = [time_turns(k_fn, p_fn) for _ in range(3)]
        ks = [k for kk, _ in turns for k in kk]
        ps = [p for _, pp in turns for p in pp]
        b_ms, b_by = bounds(name, args, got)
        dev_t = f", device {device_ms(k_fn):.4f} ms a call (torch.profiler)" \
            if name == "generate_points_eom" else ""
        print(f"{name}: exact (max abs err {err}); kernel "
              + "/".join(f"{k:.4f}" for k in ks) + " ms, plain "
              + "/".join(f"{p:.3f}" for p in ps) + f" ms, bound {b_ms:.4f} ms ({b_by}); rows "
              f"out {got[0].shape[0]}, EOM rows {ex_args[0].eq(2).sum().item()}, aux "
              f"{tuple(in_args[2].shape)}{dev_t}")
        lib = eom_library_ms(ex_args, in_args) if name == "eom_colors" else None
        rows[name] = dict(ms=sum(ks) / len(ks), plain_ms=sum(ps) / len(ps), bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err, library_ms=lib)

    # 30. the main path, counted and timed; the spies keep each frame's EOM
    # rows, plane and raw points for the checks afterwards
    seen = []
    real_recon = pipeline.reconstruct_frame

    def recon_spy(*a, **kw):
        out = real_recon(*a, **kw)
        seen.append(int((out.layer == 2).sum()))
        return out

    pipeline.reconstruct_frame = recon_spy
    try:
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, stream, recon = encode(cfg, fr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(dev.LAUNCHES)
    finally:
        pipeline.reconstruct_frame = real_recon
    split = {f: sum(getattr(st, f) for st in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s", "video_s",
                       "reconstruct_s", "recolor_s")}
    print(f"lossless warm encode: {dt / n:.4f} s/frame (JAX partitions; JAX on a CPU "
          f"{rl['jax_cpu_encode_s'] / n:.4f}); per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"lossless launches on the encode path: {launches}")
    idle = [k for k in ("generate_points_eom", "eom_colors") if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"lossless: kernels not launched on the encode path: {idle}")

    # 31. counts, stream and decode against the JAX package's
    bad = []
    for i, (e, r, rows_eom) in enumerate(zip(enc.last_encoded, rl["frames"], seen)):
        eom = codecs.decode_eom_plane(e.geometry.eom_payload)
        raw = e.raw_positions
        got = dict(patches=len(e.patches), raw_points=0 if raw is None else len(raw),
                   raw_md5=None if raw is None else frame_digest(raw, e.raw_colors),
                   eom_md5=hashlib.md5(np.ascontiguousarray(eom, "<i4").tobytes()).hexdigest(),
                   eom_codes=int((eom != 0).sum()), eom_rows=rows_eom,
                   recon_points=recon[i].point_count,
                   recon_md5=frame_digest(recon[i].positions, recon[i].colors))
        bad += [f"frame {i} {k} {v} (JAX {r[k]})" for k, v in got.items() if v != r[k]]
    if bad:
        raise AssertionError(f"lossless: differs from the JAX package: {bad}")
    print("lossless against the JAX package: patches "
          f"{[r['patches'] for r in rl['frames']]}, raw points "
          f"{[r['raw_points'] for r in rl['frames']]}, EOM codes "
          f"{[r['eom_codes'] for r in rl['frames']]}, EOM rows "
          f"{[r['eom_rows'] for r in rl['frames']]}, reconstructions: all equal")
    same_zlib = zlib.ZLIB_RUNTIME_VERSION == ref["zlib_runtime_version"]
    same_stream = hashlib.md5(stream).hexdigest() == rl["stream_md5"]
    print(f"lossless stream {len(stream)} vs {rl['stream_bytes']} bytes, byte-identical to the "
          f"JAX encoder's: {same_stream} (zlib {zlib.ZLIB_RUNTIME_VERSION} here, "
          f"{ref['zlib_runtime_version']} in the reference run)")
    if same_zlib and not same_stream:
        raise AssertionError("lossless: the stream differs from the JAX encoder's")
    if not same_stream:
        print("lossless: zlib builds differ, so the stream bytes are not comparable; held "
              "instead: every substream decodes to the encoder's planes (the decode below)")
    dec, t_dec, _ = decode_checked(dev, stream, recon, "lossless")
    for i, (a, f) in enumerate(zip(dec, fr)):
        ka = np.lexsort(np.asarray(a.positions, np.int64).T)
        kf = np.lexsort(np.asarray(f.positions, np.int64).T)
        if a.point_count != f.point_count or not np.array_equal(
                np.asarray(a.positions, np.int32)[ka], np.asarray(f.positions, np.int32)[kf]) \
                or not np.array_equal(a.colors[ka], f.colors[kf]):
            raise AssertionError(f"lossless frame {i}: the decode differs from the source")
    print(f"lossless decode: {t_dec:.4f} s/frame (JAX on a CPU "
          f"{rl['jax_cpu_decode_s'] / n:.4f}); every frame equals its source bit for bit "
          f"(points {[f.point_count for f in fr]})")
    ub = unit_bytes(stream)
    print("lossless bytes per substream (port/JAX): " + ", ".join(
        f"{k} {ub.get(k)}/{v}" for k, v in rl["unit_bytes"].items()))

    # 32. EOM under r3: the stream byte-identical to JAX's
    re_ = ref["configs"]["r3_eom"]
    fr3 = frames[:len(re_["seeds"])]
    t0 = time.perf_counter()
    enc3, stream3, recon3 = encode(config("r3_eom"), fr3)
    torch.cuda.synchronize()
    t3 = (time.perf_counter() - t0) / len(fr3)
    same3 = hashlib.md5(stream3).hexdigest() == re_["stream_md5"]
    print(f"r3+EOM encode: {t3:.4f} s/frame, stream {len(stream3)} vs {re_['stream_bytes']} "
          f"bytes, byte-identical to the JAX encoder's: {same3}")
    if not same3:
        raise AssertionError("r3+EOM: the stream differs from the JAX encoder's")
    for i, (e, r) in enumerate(zip(recon3, re_["frames"])):
        if (e.point_count, frame_digest(e.positions, e.colors)) != \
                (r["recon_points"], r["recon_md5"]):
            raise AssertionError(f"r3+EOM frame {i}: the reconstruction differs from JAX's")
    _, t_dec3, _ = decode_checked(dev, stream3, recon3, "r3+EOM")
    print(f"r3+EOM decode: {t_dec3:.4f} s/frame; the stream decodes exactly to the encoder's "
          "reconstruction, which equals JAX's")
    return rows, launches


def tools_phase(dev, frames):
    """Steps 33-36: the reconstruction tools a stream signals to the decoder
    (color smoothing, PBF, PLR), one configuration each, on the first two
    bench frames.  Returns (rows, launches)."""
    import numpy as np

    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.ops import pbf, plr, reconstruct, smoothing
    from vpcc_tpu_torch.utils.config import VPCCConfig

    ref = json.loads(TOOLS_REFERENCE.read_text())
    md5 = lambda a, dt: hashlib.md5(np.ascontiguousarray(a, dt).tobytes()).hexdigest()
    wrappers = {
        "cs": {"color_smooth": (smoothing, "color_smoothing_grid")},
        "pbf": {"pbf": (pbf, "pbf_filter_occupancy")},
        "plr": {"plr": (plr, "code_plane"), "plr_rdo": (plr, "rdo"),
                "generate_points_plr": (reconstruct, "generate_points")},
    }

    def entries(kname, args, kw):
        """(kernel call, plain call, bounds arguments) of one kept call."""
        if kname == "color_smooth":
            return (lambda: smoothing.color_smoothing_grid(*args, **kw),
                    lambda: smoothing.color_smoothing_grid_plain(*args, **kw), args)
        if kname == "pbf":
            return (lambda: pbf.pbf_filter_occupancy(*args, **kw),
                    lambda: pbf.pbf_filter_occupancy_plain(*args, **kw), (args, kw))
        if kname == "plr":
            return (lambda: plr.code_plane(*args), lambda: plr.code_plane_plain(*args), args)
        if kname == "plr_rdo":
            # the four results, on the host from both
            fields = lambda r: (*r[:3], torch.tensor([r[3]]))
            return (lambda: fields(plr.rdo(*args)), lambda: fields(plr.rdo_plain(*args)), args)
        plain_kw = {k: v for k, v in kw.items() if k != "entry"}
        return (lambda: tuple(reconstruct.generate_points(*args, **kw)),
                lambda: tuple(reconstruct.generate_points_plain(*args, **plain_kw)), (args, kw))

    rows, launches = {}, {}
    for name, rc in ref["configs"].items():
        cfg = VPCCConfig()
        for k, v in rc["overrides"].items():
            setattr(cfg, k, v)
        fr = frames[:len(rc["seeds"])]
        n = len(fr)
        if [f.point_count for f in fr] != [r["source_points"] for r in rc["frames"]]:
            raise AssertionError(f"tools {name}: the frames differ from the JAX package's")

        # 33. warm-up, keeping the tool's largest calls; the spies keep each
        # frame's PBF-filtered occupancy and smoothed colors
        seen = {"pbf": [], "cs": []}
        real_pbf, real_cs = pipeline.apply_pbf_occupancy, pipeline.apply_color_smoothing_device

        def pbf_spy(*a, **kw):
            out = real_pbf(*a, **kw)
            occ = out.cpu().numpy().astype(np.uint8)
            seen["pbf"].append(dict(pbf_occ_md5=md5(occ, np.uint8), pbf_kept=int(occ.sum())))
            return out

        def cs_spy(recon, col, cfg_):
            out = real_cs(recon, col, cfg_)
            seen["cs"].append(md5(out.cpu().numpy(), "<i4"))
            return out

        pipeline.apply_pbf_occupancy, pipeline.apply_color_smoothing_device = pbf_spy, cs_spy
        t0 = time.perf_counter()
        try:
            with Capture(wrappers[name]) as cap, \
                    CallLog(reconstruct, "generate_points") as gp_log:
                encode_driven(cfg, fr)
                torch.cuda.synchronize()
        finally:
            pipeline.apply_pbf_occupancy, pipeline.apply_color_smoothing_device = \
                real_pbf, real_cs
        print(f"tools {name} cold encode: {(time.perf_counter() - t0) / n:.4f} s/frame")
        if name == "plr":
            gp_all_check(dev, reconstruct, gp_log, "the PLR encode")
        del gp_log
        missing = sorted(set(wrappers[name]) - set(cap.calls))
        if missing:
            raise AssertionError(f"tools {name}: never called: {missing}")

        # 34. each kernel == its plain version, timed in turns
        for kname in TOOLS_KERNELS[name]:
            _, args, kw = cap.calls[kname]
            k_fn, p_fn, b_args = entries(kname, args, kw)
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{kname}: kernel differs from its plain version "
                                     f"(max abs err {err})")
            extra = ""
            if kname == "pbf":
                nb = pbf.count_border(args[0], args[2], args[4])
                if nb != pbf.count_border_plain(args[0], args[2], args[4]):
                    raise AssertionError("pbf: the border count differs from the plain version's")
                extra = f", {nb} border pixels, kept {int(got.sum())} of " \
                        f"{int((args[0] != 0).sum())}"
            elif kname == "plr_rdo":
                calls = launches_and_syncs(dev, k_fn, "plr_rdo")
                if calls != RDO_LIMITS or int(got[3]) != 0:
                    raise AssertionError(f"plr_rdo: {calls[0]} launches and {calls[1]} host "
                                         f"reads a call (limits {RDO_LIMITS}), {int(got[3])} "
                                         "sums past 2^24")
                extra = (f", {args[4].numel()} blocks, {int((args[4] > 0).sum())} in a patch, "
                         f"{args[5].shape[0]} modes, p_max {args[8]}, {calls[0]} launches and "
                         f"{calls[1]} host read a call, device {device_ms(k_fn):.4f} ms a call "
                         "(torch.profiler)")
                rdo_cases(dev)
            elif kname == "generate_points_plr":
                extra = (f", rows {got[0].shape[0]}, PLR rows {int((got[2] == 2).sum())}, device "
                         f"{device_ms(k_fn):.4f} ms a call (torch.profiler)")
            elif kname == "color_smooth":
                extra = f", rows {args[0].shape[0]}, smoothed {int((got != args[1]).any(1).sum())}"
            (k1, k2), (p1, p2) = time_turns(k_fn, p_fn)
            b_ms, b_by = bounds(kname, b_args, got)
            print(f"{kname}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")
            rows[kname] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                               bound_by=b_by, max_abs_err=err, library_ms=None)

        # 35. the main path, counted and timed
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, stream, recon = encode_driven(cfg, fr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counted = {k: v for k, v in dev.LAUNCHES.items() if v}
        split = {f: sum(getattr(st, f) for st in enc.stats) / n
                 for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s",
                           "video_s", "reconstruct_s", "recolor_s")}
        print(f"tools {name} warm encode: {dt / n:.4f} s/frame (JAX partitions; JAX on a CPU "
              f"{rc['jax_cpu_encode_s'] / n:.4f}); per frame "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        print(f"tools {name} launches on the encode path: {counted}")
        idle = [k for k in TOOLS_KERNELS[name] if counted.get(k, 0) == 0]
        if idle:
            raise AssertionError(f"tools {name}: kernels not launched on the encode path: {idle}")
        launches.update({k: counted[k] for k in TOOLS_KERNELS[name]})

        # 36. stream, reconstructions and the tools' planes against JAX's, decode
        same = hashlib.md5(stream).hexdigest() == rc["stream_md5"]
        print(f"tools {name} stream {len(stream)} vs {rc['stream_bytes']} bytes, byte-identical "
              f"to the JAX encoder's: {same}")
        if not same:
            raise AssertionError(f"tools {name}: the stream differs from the JAX encoder's")
        bad = []
        for i, (e, r) in enumerate(zip(enc.last_encoded, rc["frames"])):
            got = dict(patches=len(e.patches), recon_points=recon[i].point_count,
                       recon_md5=frame_digest(recon[i].positions, recon[i].colors))
            if "pbf_occ_md5" in r:
                got.update(seen["pbf"][i])
            if "plr_modes_md5" in r:
                got["plr_modes_md5"] = md5(e.geometry.plr_modes, "<i4")
                if e.geometry.plr_inexact:
                    bad.append(f"frame {i}: {e.geometry.plr_inexact} RDO blocks or patches "
                               "whose sums reach 2^24")
            if "smoothed_colors_md5" in r:
                got["smoothed_colors_md5"] = seen["cs"][i]
            bad += [f"frame {i} {k} {v} (JAX {r[k]})" for k, v in got.items() if v != r[k]]
        if bad:
            raise AssertionError(f"tools {name}: differs from the JAX package: {bad}")
        what = {"cs": "smoothed colors", "pbf": "PBF-filtered occupancy (kept pixels "
                f"{[r.get('pbf_kept') for r in rc['frames']]})",
                "plr": "PLR block modes (RDO sums below 2^24)"}[name]
        print(f"tools {name} against the JAX package: patches, reconstructions, {what}: "
              "all equal")
        _, t_dec, dec_launches = decode_checked(dev, stream, recon, f"tools {name}")
        want_dec = [k for k in TOOLS_KERNELS[name] if k != "plr_rdo"]
        if any(dec_launches.get(k, 0) == 0 for k in want_dec):
            raise AssertionError(f"tools {name}: the decoder did not launch {want_dec}")
        ub = unit_bytes(stream)
        print(f"tools {name} decode: {t_dec:.4f} s/frame (JAX on a CPU "
              f"{rc['jax_cpu_decode_s'] / n:.4f}); equal to the encoder's reconstruction; "
              "bytes per substream (port/JAX): "
              + ", ".join(f"{k} {ub.get(k)}/{v}" for k, v in rc["unit_bytes"].items()))
    return rows, launches


def reflectance_field(positions, seed: int):
    """The seeded (N,) uint16 reflectance of a frame's points (as
    tests/torch_make_attr_options_reference.py makes it)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = np.asarray(positions, np.int64)
    r = 21 * (p[:, 0] + p[:, 1] + p[:, 2]) + rng.integers(0, 1024, p.shape[0])
    return np.clip(r, 0, 65535).astype(np.uint16)


def attr_options_phase(dev, frames):
    """Steps 37-40: the attribute options (the reflectance attribute,
    attributeBGFill 0 and 2) on the first two bench frames.  Returns (rows,
    launches)."""
    import numpy as np

    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.ops import neighbors, padding, recolor
    from vpcc_tpu_torch.ops.metrics import compute_metrics
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.ply import PointCloudData
    from vpcc_tpu_torch.video import codecs, hevc

    ref = json.loads(ATTR_OPTIONS_REFERENCE.read_text())
    md5 = lambda a, dt: hashlib.md5(np.ascontiguousarray(a, dt).tobytes()).hexdigest()
    host = lambda t: t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    def plain_transfer(src_pos, src_refl, tgt_pos, grid_bits):
        """transfer_reflectance from the plain versions of kernels M and E."""
        order, sk = recolor.sorted_source_keys(src_pos, grid_bits)
        eidx, has, _, _ = recolor.exact_match_plain(order, sk, tgt_pos, grid_bits)
        nidx, _ = neighbors.knn_plain(neighbors.build_grid(src_pos, grid_bits), tgt_pos, 1, 6)
        return src_refl[torch.where(has, eidx, nidx[:, 0]).long()].to(torch.int32)

    def entries(kname, args):
        """(kernel call, plain call) of one kept call (the dilation as the
        main path calls it: rounded and clipped)."""
        if kname == "bg_dilate":
            return (lambda: padding.dilate_fill(*args, rounded=True),
                    lambda: (lambda r: (padding.round_clip_plain(r[0]), r[1]))(
                        padding.dilate_fill_plain(*args)))
        if kname == "bg_harmonic":
            return (lambda: padding.harmonic_fill(*args[:2], rounded=True),
                    lambda: padding.round_clip_plain(padding.harmonic_fill_plain(*args[:2])))
        if kname == "attr_paint_scalar":
            return (lambda: pipeline.paint_scalar(*args),
                    lambda: pipeline.paint_scalar_plain(*args))
        return (lambda: pipeline.gather_decoded_scalar(*args),
                lambda: pipeline.gather_decoded_scalar_plain(*args))

    def check(kname, k_fn, p_fn, b_args, extra="", reps_k=20, reps_p=3):
        if kname in ("attr_paint_scalar", "attr_gather_scalar"):   # short calls
            reps_k = 100
            extra += f", device {graph_ms(k_fn):.4f} ms a call (CUDA graph replay)"
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        if kname == "bg_dilate":
            if got[1] != want[1]:
                raise AssertionError(f"bg_dilate: {got[1]} passes, plain {want[1]}")
            x_k, x_p = padding.dilate_fill(*b_args)[0], padding.dilate_fill_plain(*b_args)[0]
            if max_abs_err(x_k, x_p) != 0:
                raise AssertionError("bg_dilate: the float planes differ from the plain "
                                     f"version's (max abs err {max_abs_err(x_k, x_p)})")
            calls = launches_and_syncs(dev, k_fn, "bg_dilate")
            if calls[0] > WALK_LIMITS["bg_dilate"][0] or calls[1] > WALK_LIMITS["bg_dilate"][1]:
                raise AssertionError(f"bg_dilate: {calls[0]} launches and {calls[1]} host reads "
                                     f"a call, limits {WALK_LIMITS['bg_dilate']}")
            extra += (f", {got[1]} passes, the float planes exact too, {calls[0]} launches and "
                      f"{calls[1]} host read a call")
            got, want = got[0], want[0]
        if kname == "bg_harmonic":
            planes, occ = b_args[:2]
            padding.reset_inexact()
            x_p = padding.harmonic_fill_plain(planes, occ)
            n_p = padding.inexact_blocks()
            padding.reset_inexact()
            x_k = padding.harmonic_fill(planes, occ)
            n_k = padding.inexact_blocks()
            if max_abs_err(x_k, x_p) != 0 or n_k != n_p or n_k != 0:
                raise AssertionError(f"bg_harmonic: the float planes differ from the plain "
                                     f"version's (max abs err {max_abs_err(x_k, x_p)}) or the "
                                     f"push's sums past 2^24 ({n_k}, plain {n_p}) are not 0")
            calls = launches_and_syncs(dev, k_fn, "bg_harmonic")
            if calls[0] > HARMONIC_LIMITS[0] or calls[1] > HARMONIC_LIMITS[1]:
                raise AssertionError(f"bg_harmonic: {calls[0]} launches and {calls[1]} host "
                                     f"reads a call, limits {HARMONIC_LIMITS}")
            extra += (f", the float planes exact too, push sums past 2^24: {n_k}, "
                      f"{calls[0]} launches and {calls[1]} host reads a call, device "
                      f"{device_ms(k_fn):.4f} ms a call (torch.profiler)")
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{kname}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        (k1, k2), (p1, p2) = time_turns(k_fn, p_fn, reps_k=reps_k, reps_p=reps_p)
        b_ms, b_by = bounds(kname, b_args, got)
        print(f"{kname}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")
        return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err, library_ms=None)

    rows, launches = {}, {}
    for name, rc in ref["configs"].items():
        cfg = VPCCConfig()
        for k, v in rc["overrides"].items():
            setattr(cfg, k, v)
        fr = frames[:len(rc["seeds"])]
        n = len(fr)
        with_refl = "source_refl_md5" in rc["frames"][0]
        if with_refl:
            fr = [PointCloudData(f.positions, f.colors,
                                 reflectances=reflectance_field(f.positions, s))
                  for f, s in zip(fr, rc["seeds"])]
        bad = [f"frame {i}" for i, (f, r) in enumerate(zip(fr, rc["frames"]))
               if f.point_count != r["source_points"] or
               (with_refl and md5(f.reflectances, "<u2") != r["source_refl_md5"])]
        if bad:
            raise AssertionError(f"attribute options {name}: the frames (or their seeded "
                                 f"reflectance) differ from the JAX package's: {bad}")

        # 37. warm-up, keeping the new entries' largest calls, and with
        # reflectance kernels I and A's calls on the reflectance planes
        wrappers = {"bg_dilate": (padding, "dilate_fill"),
                    "bg_harmonic": (padding, "harmonic_fill"),
                    "attr_paint_scalar": (pipeline, "paint_scalar"),
                    "attr_gather_scalar": (pipeline, "gather_decoded_scalar")}
        wanted = ATTR_OPTIONS_KERNELS[name]
        wrappers = {k: v for k, v in wrappers.items() if k in wanted}
        refl_calls = {}
        real_enc, real_dec = codecs.encode_reflectance, codecs.decode_reflectance

        def enc_spy(*a, **kw):
            with Capture({"wavefront_encode32": (hevc, "wavefront_encode32")}) as c:
                out = real_enc(*a, **kw)
            refl_calls.update(c.calls)
            return out

        def dec_spy(*a, **kw):
            with Capture({"wavefront_decode32": (hevc, "wavefront_decode32")}) as c:
                out = real_dec(*a, **kw)
            refl_calls.update(c.calls)
            return out

        codecs.encode_reflectance, codecs.decode_reflectance = enc_spy, dec_spy
        t0 = time.perf_counter()
        try:
            with CallLog(hevc, "deblock_planes") as db_log:
                with Capture(wrappers) as cap:
                    _, stream0, recon0 = encode_driven(cfg, fr)
                    torch.cuda.synchronize()
                t_cold = (time.perf_counter() - t0) / n
                if with_refl:
                    decode_checked(dev, stream0, recon0, f"attribute options {name} (warm-up)")
        finally:
            codecs.encode_reflectance, codecs.decode_reflectance = real_enc, real_dec
        print(f"attribute options {name} cold encode: {t_cold:.4f} s/frame")
        if db_log.calls:   # kernel O on every deblocked plane (the lossless video has none)
            deblock_all_check(dev, hevc, db_log.calls, f"the {name} encode and decode",
                              maxval=1023 if name == "refl" else None)
        del db_log
        missing = sorted(set(wrappers) - set(cap.calls))
        if missing:
            raise AssertionError(f"attribute options {name}: never called: {missing}")

        # 38. each new entry == its plain version, timed in turns
        for kname in wanted if name != "refl_lossless" else ():   # held under "refl"
            _, args, _ = cap.calls[kname]
            k_fn, p_fn = entries(kname, args)
            extra = ""
            if kname in ("bg_dilate", "bg_harmonic"):
                extra = f", planes {tuple(args[0].shape)}"
            elif kname == "attr_paint_scalar":
                extra = f", rows {args[2].shape[0]}, max sample {int(args[2].max())}"
            rows[kname] = check(kname, k_fn, p_fn, args, extra)
        if name == "refl":
            t_put, t_get = p_library_ms("scalar", cap.calls["attr_paint_scalar"][1],
                                        cap.calls["attr_gather_scalar"][1],
                                        pipeline.gather_decoded_scalar_plain, clamp=False)
            rows["attr_paint_scalar"]["library_ms"] = t_put
            rows["attr_gather_scalar"]["library_ms"] = t_get
        if name == "bgfill2":
            # smooth_fill (no caller): kernel W's harmonic entry
            planes, occ = cap.calls["bg_harmonic"][1][:2]
            check("smooth_fill", lambda: padding.smooth_fill(planes, occ),
                  lambda: padding.smooth_fill_plain(planes, occ),
                  (planes, occ), f", planes {tuple(planes.shape)} (no caller; kernel W's "
                  "harmonic entry)")
            harmonic_cases(dev)
        if name == "refl":
            for kname, plain in (("wavefront_encode32", hevc.wavefront_encode32_plain),
                                 ("wavefront_decode32", hevc.wavefront_decode32_plain)):
                _, args, _ = refl_calls[kname]
                kern = getattr(hevc, kname)
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                err = max_abs_err(tuple(got), tuple(want)) if isinstance(got, tuple) \
                    else max_abs_err(got, want)
                if err != 0:
                    raise AssertionError(f"{kname} on the reflectance planes: kernel differs "
                                         f"from its plain version (max abs err {err})")
                maxv = args[-3] if kname == "wavefront_encode32" else args[8]
                if set(maxv.tolist()) != {1023}:
                    raise AssertionError(f"{kname}: the kept call is not a reflectance plane")
                print(f"{kname} on the reflectance planes: exact (max abs err {err}); maxval "
                      f"{sorted(set(maxv.tolist()))}, tiles {tuple(args[0].shape)}")
        # 39. the main path, counted and timed; the spies keep each frame's
        # transferred reflectance, coded images and dilation passes
        seen = {"refl": [], "images": [], "passes": [], "tgt": []}
        real_tr, real_attr = recolor.transfer_reflectance, codecs.AttributeSubstreamEncoder.encode
        real_dil = padding.dilate_fill

        def tr_spy(src_pos, src_refl, tgt_pos, *a, **kw):
            out = real_tr(src_pos, src_refl, tgt_pos, *a, **kw)
            seen["refl"].append(md5(host(out), "<i4"))
            seen["tgt"].append((src_pos, src_refl, tgt_pos))
            return out

        def attr_spy(self, img, *a, **kw):
            seen["images"].append(md5(host(img), "<i4"))
            return real_attr(self, img, *a, **kw)

        def dil_spy(*a, **kw):
            out = real_dil(*a, **kw)
            seen["passes"].append(out[1])
            return out

        recolor.transfer_reflectance, codecs.AttributeSubstreamEncoder.encode = tr_spy, attr_spy
        padding.dilate_fill = dil_spy
        try:
            dev.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, stream, recon = encode_driven(cfg, fr)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counted = {k: v for k, v in dev.LAUNCHES.items() if v}
        finally:
            recolor.transfer_reflectance, codecs.AttributeSubstreamEncoder.encode = \
                real_tr, real_attr
            padding.dilate_fill = real_dil
        split = {f: sum(getattr(st, f) for st in enc.stats) / n
                 for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s",
                           "video_s", "reconstruct_s", "recolor_s")}
        print(f"attribute options {name} warm encode: {dt / n:.4f} s/frame (JAX partitions; "
              f"JAX on a CPU {rc['jax_cpu_encode_s'] / n:.4f}); per frame "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        print(f"attribute options {name} launches on the encode path: {counted}")
        if seen["passes"]:
            print(f"attribute options {name}: dilation passes per image stack (T0 and T1, "
                  f"3 channels each) {seen['passes']}")
        idle = [k for k in wanted if counted.get(k, 0) == 0]
        if idle:
            raise AssertionError(f"attribute options {name}: not launched on the encode path: "
                                 f"{idle}")
        if name != "refl_lossless":
            launches.update({k: counted[k] for k in wanted})
        if name == "refl":
            src_pos, src_refl, tgt_pos = seen["tgt"][-1]
            check("transfer_reflectance",
                  lambda: recolor.transfer_reflectance(src_pos, src_refl, tgt_pos, 10),
                  lambda: plain_transfer(src_pos, src_refl, tgt_pos, 10),
                  (src_pos, src_refl, tgt_pos),
                  f", {tgt_pos.shape[0]} targets, {src_pos.shape[0]} sources (kernels M, E)")

        # 40. the stream, the stages and the decode against JAX's
        same = hashlib.md5(stream).hexdigest() == rc["stream_md5"]
        print(f"attribute options {name} stream {len(stream)} vs {rc['stream_bytes']} bytes, "
              f"byte-identical to the JAX encoder's: {same}")
        if not same or enc.last_stream_stats != rc["stream_stats"]:
            raise AssertionError(f"attribute options {name}: the stream differs from the JAX "
                                 f"encoder's ({enc.last_stream_stats} vs {rc['stream_stats']})")
        bad = []
        for i, r in enumerate(rc["frames"]):
            got = dict(patches=len(enc.last_encoded[i].patches),
                       t0_md5=seen["images"][2 * i], t1_md5=seen["images"][2 * i + 1],
                       recon_points=recon[i].point_count,
                       recon_md5=frame_digest(recon[i].positions, recon[i].colors))
            if with_refl:
                got.update(refl_md5=seen["refl"][i],
                           recon_refl_md5=md5(recon[i].reflectances, "<u2"))
            bad += [f"frame {i} {k} {v} (JAX {r[k]})" for k, v in got.items() if v != r[k]]
        if bad:
            raise AssertionError(f"attribute options {name}: differs from the JAX package: {bad}")
        print(f"attribute options {name} against the JAX package: patches, T0/T1 images, "
              + ("transferred reflectances, " if with_refl else "")
              + "reconstructions: all equal")
        dec, t_dec, _ = decode_checked(dev, stream, recon, f"attribute options {name}")
        if with_refl:
            for i, (a, b) in enumerate(zip(dec, recon)):
                if a.reflectances is None or not np.array_equal(a.reflectances, b.reflectances):
                    raise AssertionError(f"attribute options {name} frame {i}: the decoded "
                                         "reflectances differ from the encoder's")
        print(f"attribute options {name} decode: {t_dec:.4f} s/frame (JAX on a CPU "
              f"{rc['jax_cpu_decode_s'] / n:.4f}); equal to the encoder's reconstruction"
              + (", reflectances included" if with_refl else ""))
        if name == "refl":
            for i, (f, r, rr) in enumerate(zip(fr, recon, rc["frames"])):
                m = compute_metrics(np.asarray(f.positions, np.int32), f.colors,
                                    np.asarray(r.positions, np.int32), r.colors,
                                    resolution=cfg.resolution, grid_bits=cfg.geometryBitDepth3D,
                                    src_refl=f.reflectances, rec_refl=r.reflectances,
                                    device="cuda")
                delta = abs(m.reflectance_psnr - rr["reflectance_psnr"])
                print(f"attribute options refl frame {i}: reflectance PSNR "
                      f"{m.reflectance_psnr:.6f} dB (JAX {rr['reflectance_psnr']:.6f})")
                if not delta <= METRICS_PSNR_TOL_DB:
                    raise AssertionError(f"refl frame {i}: reflectance PSNR off JAX's by {delta}")
        ub = unit_bytes(stream)
        print(f"attribute options {name} bytes per substream (port/JAX): "
              + ", ".join(f"{k} {ub.get(k)}/{v}" for k, v in rc["unit_bytes"].items()))
    frontier_cases(dev, "W")   # the dilation's crafted cases
    return rows, launches


def seg_options_phase(dev, frames):
    """Steps 41-45: the segmentation options (normalOrientation 0 / 2 / 4,
    highGradientSeparation, ROI partitioning) and tetris packing on the
    first two bench frames.  Returns (rows, launches)."""
    import dataclasses

    import numpy as np

    from vpcc_tpu_torch import encoder as enc_mod
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import metrics, normals, segmentation, voxelize
    from vpcc_tpu_torch.utils.config import VPCCConfig

    ref = json.loads(SEG_OPTIONS_REFERENCE.read_text())
    so = np.load(SEG_OPTIONS_PARTITIONS)
    fp = np.load(FRONT_PARTITIONS)
    d = torch.device("cuda")
    t32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32), device=d)
    fr = frames[:len(ref["configs"]["orient0"]["seeds"])]
    n = len(fr)
    bad = [i for i, f in enumerate(fr)
           if f.point_count != ref["configs"]["orient0"]["frames"][i]["source_points"]]
    if bad:
        raise AssertionError(f"segmentation options: frames {bad} differ from the JAX package's")

    def config(name):
        cfg = VPCCConfig()
        for k, v in ref["configs"][name]["overrides"].items():
            setattr(cfg, k, v)
        return cfg

    class RoiDriven(Encoder):
        """The encoder with each ROI chunk's voxel partition replaced, in the
        order the chunks are segmented, by the JAX encoder's (the chunks'
        point counts are kept to check them)."""

        def __init__(self, cfg, parts):
            super().__init__(cfg, device="cuda")
            self.parts, self.chunk_points = list(parts), []

        def segment_dispatch(self, pc_host):
            self.chunk_points.append(pc_host.point_count)
            seg = super().segment_dispatch(pc_host)
            return Encoder.with_partition(seg, t32(self.parts.pop(0)))

    def make_encoder(name):
        """(encoder, segs) of one configuration: orient0/2/4 segment the
        frames themselves; hgs and tetris are driven by the committed JAX
        partitions (hgs also by JAX's voxel alt/weak), roi chunk by chunk."""
        cfg = config(name)
        rc = ref["configs"][name]
        if name.startswith("orient"):
            return Encoder(cfg, device="cuda"), None
        if name == "roi":
            return RoiDriven(cfg, [so[f"roi_{f}_{c}"] for f in range(n)
                                   for c in range(len(rc["chunk_points"][f]))]), None
        enc = Encoder(cfg, device="cuda")
        segs = []
        for i, f in enumerate(fr):
            seg = Encoder.with_partition(enc.segment_dispatch(f), t32(fp[f"refined_{i}"]))
            if name == "hgs":
                alt_v = t32(so[f"hgs_alt_{i}"])
                weak_v = torch.as_tensor(so[f"hgs_weak_{i}"], device=d)
                seg = dataclasses.replace(seg, hg=(
                    voxelize.gather_point_values(alt_v, seg.point_vox),
                    voxelize.gather_point_values(weak_v, seg.point_vox)))
            segs.append(seg)
        return enc, segs

    # 41. the port's own segmentation under modes 0, 2, 4 and with the
    # high-gradient aux: partition agreement with the JAX package's
    for name in ("orient0", "orient2", "orient4", "hgs"):
        for i, f in enumerate(fr):
            seg = Encoder(config(name), device="cuda").segment_dispatch(f)
            want = fp[f"refined_{i}"] if name == "hgs" else so[f"{name}_{i}"]
            a = float(np.mean(seg.part.cpu().numpy() == want))
            extra = ""
            if name == "orient4":
                extra = f", {normals.last_flood_sweeps} flood sweeps signed voxels"
            if name == "hgs":
                alt, weak = segmentation.high_gradient_aux(seg.normals, t32(want), seg.orients)
                extra = (f"; given JAX's partition, alt agreement "
                         f"{float(np.mean(alt.cpu().numpy() == so[f'hgs_alt_{i}'])):.6f}, weak "
                         f"{float(np.mean(weak.cpu().numpy() == so[f'hgs_weak_{i}'])):.6f}")
            print(f"segmentation options {name} frame {i}: own partition agreement {a:.6f} "
                  f"of {len(want)} voxels{extra}")
            if a < PARTITION_FLOOR:
                raise AssertionError(f"{name} frame {i}: partition agreement {a} below "
                                     f"{PARTITION_FLOOR}")

    wrappers = {"orient_viewpoint": (normals, "orient_normals_viewpoint"),
                "orient": (normals, "orient_normals_spanning_tree"),
                "high_gradient_aux": (enc_mod, "high_gradient_aux")}
    calls, launches = {}, {}
    src = [(torch.as_tensor(np.asarray(f.positions, np.int32), device=d),
            torch.as_tensor(f.colors, device=d)) for f in fr]
    src_normals = [metrics.estimate_normals(p, 10, device=d) for p, _ in src]
    for name, rc in ref["configs"].items():
        wanted = SEG_OPTIONS_KERNELS[name]
        # 42. warm-up, keeping the new entries' largest calls
        t0 = time.perf_counter()
        with Capture({k: wrappers[k] for k in wanted}) as cap:
            enc, segs = make_encoder(name)
            enc.encode_gof(fr, segs=segs)
            torch.cuda.synchronize()
        t_cold = (time.perf_counter() - t0) / n
        missing = sorted(set(wanted) - set(cap.calls))
        if missing:
            raise AssertionError(f"segmentation options {name}: never called: {missing}")
        calls.update(cap.calls)
        # 43. the main path, counted and timed
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, segs = make_encoder(name)
        stream, recon = enc.encode_gof(fr, segs=segs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counted = {k: v for k, v in dev.LAUNCHES.items() if v}
        split = {f: sum(getattr(st, f) for st in enc.stats) / n
                 for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s",
                           "video_s", "reconstruct_s", "recolor_s")}
        driven = "own segmentation" if name.startswith("orient") else "JAX partitions"
        print(f"segmentation options {name} encode: cold {t_cold:.4f}, warm {dt / n:.4f} "
              f"s/frame ({driven}; JAX on a CPU {rc['jax_cpu_encode_s'] / n:.4f}); per frame "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        print(f"segmentation options {name} launches on the encode path: {counted}")
        idle = [k for k in (*wanted, *FRONT_KERNELS) if counted.get(k, 0) == 0]
        if idle:
            raise AssertionError(f"segmentation options {name}: not launched on the encode "
                                 f"path: {idle}")
        launches.update({k: counted[k] for k in wanted})
        if name == "roi":
            want_pts = [c for f in rc["chunk_points"] for c in f]
            if enc.chunk_points != want_pts:
                raise AssertionError(f"roi chunks {enc.chunk_points} vs JAX's {want_pts}")
        # 44. the stream against JAX's: identical where driven by its
        # partitions, within the RD gate for orient4's own segmentation
        same = hashlib.md5(stream).hexdigest() == rc["stream_md5"]
        got = [dict(patches=len(e.patches), recon_points=r.point_count,
                    recon_md5=frame_digest(r.positions, r.colors))
               for e, r in zip(enc.last_encoded, recon)]
        print(f"segmentation options {name} stream {len(stream)} vs {rc['stream_bytes']} bytes, "
              f"byte-identical to the JAX encoder's: {same}; patches "
              f"{[g['patches'] for g in got]} vs {[r['patches'] for r in rc['frames']]}")
        if not name.startswith("orient"):
            diff = [f"frame {i} {k} {v} (JAX {r[k]})" for i, (g, r) in
                    enumerate(zip(got, rc["frames"])) for k, v in g.items() if v != r[k]]
            if not same or enc.last_stream_stats != rc["stream_stats"] or diff:
                raise AssertionError(f"segmentation options {name}: differs from the JAX "
                                     f"encoder: {diff or enc.last_stream_stats}")
        else:
            mean = psnr_means([metrics.compute_metrics(
                p, c, r.positions, r.colors, resolution=1023, src_normals=nrm, grid_bits=10,
                device=d) for (p, c), nrm, r in zip(src, src_normals, recon)])
            d_bytes = len(stream) / rc["stream_bytes"] - 1.0
            deltas = {k: mean[k] - rc["mean"][k] for k in mean}
            print(f"segmentation options {name} RD against JAX's (held): bytes "
                  f"{100 * d_bytes:+.4f} %, mean PSNR "
                  + ", ".join(f"{k} {mean[k]:.4f} ({v:+.4f})" for k, v in deltas.items()))
            if (abs(d_bytes) > RD_BYTES_TOL
                    or max(abs(v) for v in deltas.values()) > RD_PSNR_TOL_DB):
                raise AssertionError(f"{name} RD gate: bytes {100 * d_bytes:+.3f} % (limit "
                                     f"{100 * RD_BYTES_TOL} %), PSNR deltas {deltas} (limit "
                                     f"{RD_PSNR_TOL_DB} dB)")
        _, t_dec, _ = decode_checked(dev, stream, recon, f"segmentation options {name}")
        print(f"segmentation options {name} decode: {t_dec:.4f} s/frame, equal to the "
              "encoder's reconstruction")

    # 45. X's entries and F's new entry == their plain versions on the
    # largest call of the main path, timed in turns
    rows = {}
    _, args, kw = calls["orient_viewpoint"]
    entries = {
        "orient_viewpoint": (lambda: normals.orient_normals_viewpoint(*args, **kw),
                             lambda: normals.orient_normals_viewpoint_plain(*args, **kw),
                             args, 20, 3),
    }
    _, f_args, f_kw = calls["orient"]
    entries["orient"] = (
        lambda: (normals.orient_normals_spanning_tree(*f_args, **f_kw),
                 normals.last_flood_sweeps),
        lambda: normals.orient_normals_spanning_tree_plain(*f_args, **f_kw),
        (*f_args, f_kw.get("pad_rows", False)), 5, 1)
    _, h_args, h_kw = calls["high_gradient_aux"]
    entries["high_gradient_aux"] = (lambda: segmentation.high_gradient_aux(*h_args),
                                    lambda: segmentation.high_gradient_aux_plain(*h_args),
                                    h_args, 20, 3)
    for kname, (k_fn, p_fn, b_args, reps_k, reps_p) in entries.items():
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        extra = f", {b_args[0].shape[0]} rows"
        if kname == "orient":
            if got[1] != want[1]:
                raise AssertionError(f"orient: {got[1]} flood sweeps, plain {want[1]}")
            calls = launches_and_syncs(dev, k_fn, "orient")
            if calls[0] > WALK_LIMITS["orient"][0] or calls[1] > WALK_LIMITS["orient"][1]:
                raise AssertionError(f"orient: {calls[0]} launches and {calls[1]} host reads "
                                     f"a call, limits {WALK_LIMITS['orient']}")
            extra += (f", {got[1]} sweeps signed voxels, pad_rows {b_args[-1]}, {calls[0]} "
                      f"launches and {calls[1]} host read a call")
            got, want = got[0], want[0]
        err = max_abs_err(tuple(got), tuple(want)) if isinstance(got, tuple) \
            else max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{kname}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        (k1, k2), (p1, p2) = time_turns(k_fn, p_fn, reps_k=reps_k, reps_p=reps_p)
        b_ms, b_by = bounds(kname, b_args, got)
        print(f"{kname}: exact (max abs err {err}); kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")
        rows[kname] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err, library_ms=None)
    frontier_cases(dev, "X")   # the flood's crafted cases
    return rows, launches


def level_entry_fns(neighbors, recolor, cap) -> dict:
    """name -> (kernel, plain version, B launches of the single-frame
    entries) of the level path's batched entries of kernels E and M on
    their kept calls."""
    grids, q, k, bucket = cap["grid_knn_batch"]
    order, sk, tgt, bits = cap["recolor_exact_batch"]
    b_args = cap["recolor_blend_batch"]
    col, idx, d2, tidx, td2, eidx, has, gf, cd2, doff, gb = b_args

    def knn_frames():
        outs = [neighbors.knn(grids.frame(b), q[b], k, bucket) for b in range(q.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def exact_frames():
        outs = [recolor.exact_match(order[b], sk[b], tgt[b], bits)[:3]
                for b in range(tgt.shape[0])]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    def blend_frames():
        return torch.stack([
            recolor.blend_merge(col[b], eidx[b], has[b], None, idx[b], d2[b], None, tidx[b],
                                td2[b], gf, cd2, doff, gb)
            for b in range(col.shape[0])])

    return {
        "grid_knn_batch": (lambda: neighbors.knn_batch(grids, q, k, bucket),
                           lambda: neighbors.knn_batch_plain(grids, q, k, bucket), knn_frames),
        "recolor_exact_batch": (lambda: recolor.exact_match_batch(order, sk, tgt, bits),
                                lambda: recolor.exact_match_batch_plain(order, sk, tgt, bits),
                                exact_frames),
        "recolor_blend_batch": (lambda: recolor.blend_batch(*b_args),
                                lambda: recolor.blend_batch_plain(*b_args), blend_frames),
    }


def level_m_all_check(dev, recolor, ex_log, bl_log) -> None:
    """Kernel M's frame-batched entries against their plain versions on
    every call the CallLogs kept, bit for bit, one launch a call and no host
    synchronisation (sync debug mode "error")."""
    for log, name, kern, plain in (
            (ex_log, "recolor_exact_batch", recolor.exact_match_batch,
             recolor.exact_match_batch_plain),
            (bl_log, "recolor_blend_batch", recolor.blend_batch, recolor.blend_batch_plain)):
        if not log.calls:
            raise AssertionError(f"{name}: no call captured on the level path")
        for i, a in enumerate(log.calls):
            got = []
            if no_sync_launches(dev, name, lambda: got.append(kern(*a))) != 1:
                raise AssertionError(f"{name} call {i}: expected one launch a call")
            if max_abs_err(got[0], plain(*a)) != 0:
                raise AssertionError(f"{name} call {i}: kernel differs from its plain version")
        print(f"{name}: all {len(log.calls)} captured calls of the level path exact, one launch "
              "a call, no host synchronisation (sync debug mode \"error\"); frames x calls: "
              + ", ".join(f"{k} x {v}" for k, v in collections.Counter(
                  a[0].shape[0] for a in log.calls).items()))


def level_phase(dev, cfg, frames, segs, r3_stream):
    """Steps 47-50: the level-batched GOF path (`encode_gof(parallel=True)`,
    the frame-batched entries of kernels E and M).  Returns (rows,
    launches)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import neighbors, padding, reconstruct, recolor, smoothing
    from vpcc_tpu_torch.parallel import gof
    from vpcc_tpu_torch.video import hevc

    n = len(frames)
    ref_parts = np.load(FRONT_PARTITIONS)

    def driven_segs(enc):
        return [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
            ref_parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]

    # 47. cold level-batched encode, keeping each batched entry's largest
    # call
    kept = {}
    real = {"grid_knn_batch": (neighbors, "knn_batch"),
            "recolor_exact_batch": (recolor, "exact_match_batch"),
            "recolor_blend_batch": (recolor, "blend_batch")}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in real.items()}

    def keep(name, fn):
        sig = inspect.signature(fn)

        def spy(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            a = tuple(bound.arguments.values())
            size = sum(t.numel() for t in a if torch.is_tensor(t))
            if name == "grid_knn_batch":
                size += a[0].order.numel()
            if name not in kept or size > kept[name][0]:
                kept[name] = (size, a)
            return fn(*a)
        return spy

    for name, (mod, attr) in real.items():
        setattr(mod, attr, keep(name, saved[name]))
    try:
        t0 = time.perf_counter()
        enc0 = Encoder(cfg, device="cuda")
        with CallLog(hevc, "motion_search") as j_calls, \
                CallLog(hevc, "deblock_planes") as db_log, \
                CallLog(hevc, "rgb_to_planes") as q_log, \
                CallLog(reconstruct, "generate_points") as gp_log, \
                CallLog(recolor, "exact_match_batch") as ex_log, \
                CallLog(recolor, "blend_batch") as bl_log, \
                CallLog(smoothing, "grid_smooth") as gs_log, \
                CallLog(padding, "push_pull_round") as l_log, \
                CallLog(hevc, "half_pel_mc") as b_log:
            stream0, _ = enc0.encode_gof(frames, parallel=True, segs=segs)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    finally:
        for name, (mod, attr) in real.items():
            setattr(mod, attr, saved[name])
    motion_all_check(hevc, j_calls.calls, "the level path's plane stacks")
    deblock_all_check(dev, hevc, db_log.calls, "the level path's plane stacks")
    color_batch_check(hevc, q_log.calls, "the level path (batches of a level's images)")
    if max(len(a[0]) if isinstance(a[0], list) else 1 for a in q_log.calls) < 2:
        raise AssertionError("rgb_to_planes: no batch of several images on the level path")
    gp_all_check(dev, reconstruct, gp_log, "the level path")
    level_m_all_check(dev, recolor, ex_log, bl_log)
    gs_all_check(dev, smoothing, gs_log, "the level path")
    pp_all_check(dev, padding, l_log.calls, "the level path", need_stack="planar")
    b_all_check(dev, hevc, b_log.calls, "the level path", bs=32)
    del j_calls, db_log, q_log, gp_log, ex_log, bl_log, gs_log, l_log, b_log
    parent, _ = enc0.gof_structure(n)
    groups = gof.level_groups(gof.level_schedule(parent), parent,
                              [(e.height, e.width) for e in enc0.last_encoded])
    print(f"level-batched GOF: cold encode {cold:.2f}s = {cold / n:.4f} s/frame; groups: "
          + "; ".join(f"level {lv} {h}x{w} {'inter' if ok else 'intra'} frames {fr}"
                      for lv, (h, w, ok), fr in groups))

    # 48. the path counted and timed, in turns with the sequential encode
    def run(parallel):
        enc = Encoder(cfg, device="cuda")
        padding.reset_inexact()
        dev.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = enc.encode_gof(frames, parallel=parallel, segs=driven_segs(enc))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, out, dict(dev.LAUNCHES), padding.inexact_blocks(),
                enc)

    t_s1, (s_seq, _), _, in_seq, _ = run(False)
    lb_wrap, lb_name = lb_wrappers(padding, hevc)
    with Capture({"sao": (hevc, "sao_search_apply"), **oq_wrappers(hevc),
                  "grid_smooth": (smoothing, "grid_smooth"),
                  "m_exact": (recolor, "exact_match_batch"),
                  "m_blend": (recolor, "blend_batch"), **lb_wrap}, rename=lb_name,
                 keep=False) as k_calls:
        t_p1, (stream, recon), launches, inexact, enc = run(True)
    m_d_calls(launches, k_calls.counts, "the level-batched path", n,
              [("recolor_exact_batch", k_calls.counts["m_exact"], 1),
               ("recolor_blend_batch", k_calls.counts["m_blend"], 1)])
    one_a_call("sao", launches, k_calls.counts, "the level-batched path")
    lb_launch_check(launches, k_calls.counts, "the level-batched path")
    oq_one_a_call(launches, k_calls.counts, "the level-batched path")
    print_calls(k_calls.counts, "the level-batched path", n)
    t_p2 = run(True)[0]
    t_s2 = run(False)[0]
    split = {f: sum(getattr(s, f) for s in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s", "video_s",
                       "reconstruct_s", "recolor_s")}
    print(f"level-batched GOF warm encode: {t_p1 / n:.4f}/{t_p2 / n:.4f} s/frame, sequential "
          f"{t_s1 / n:.4f}/{t_s2 / n:.4f} s/frame (in turns: seq, par, par, seq); per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"launches on the level-batched path ({len(groups)} level groups): {launches}")
    print("launches per level group: " + ", ".join(
        f"{k} {v / len(groups):.2f}" for k, v in launches.items() if v))
    idle = [k for k in LEVEL_PATH if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the level-batched path: {idle}")
    fixture = FIXTURE.read_bytes()
    same = (stream == r3_stream, stream == s_seq, stream == fixture, stream == stream0)
    print(f"level-batched GOF stream {len(stream)} bytes: byte-identical to the sequential r3 "
          f"stream: {same[0]} (this phase's: {same[1]}), to the JAX encoder's fixture: "
          f"{same[2]}, to the cold run's: {same[3]}; push-pull blocks reaching 2^24 where "
          f"XLA's order is not established: {inexact} (sequential: {in_seq})")
    if not all(same) or inexact or in_seq:
        raise AssertionError("level-batched GOF: the stream differs from the sequential / JAX "
                             "encoder's, or push-pull blocks of unknown order reach 2^24")
    _, t_dec, _ = decode_checked(dev, stream, recon, "level-batched GOF")
    print(f"level-batched GOF decode: {t_dec:.4f} s/frame, equal to the encoder's "
          "reconstruction")

    # 49. the device-idle share of the largest warm level group (its
    # record_function range in gof.py)
    enc = Encoder(cfg, device="cuda")
    segs2 = driven_segs(enc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        enc.encode_gof(frames, parallel=True, segs=segs2)
        torch.cuda.synchronize()
    events = prof.events()
    on_card = lambda e: "CUDA" in str(getattr(e, "device_type", ""))
    ranges = [e for e in events if e.name.startswith("gof level ") and not on_card(e)]
    big = max(ranges, key=lambda e: (int(e.name.rsplit("B=", 1)[1]), -e.time_range.start))
    w0, w1 = big.time_range.start, big.time_range.end
    # kernels, copies and sets inside the range (not the range's own
    # annotation on the card's timeline)
    busy = sum(max(min(e.time_range.end, w1) - max(e.time_range.start, w0), 0.0)
               for e in events if on_card(e) and not e.name.startswith("gof level "))
    wall = (w1 - w0) / 1e6
    print(f"device trace of one warm level group ({big.name}): wall {wall:.4f}s, device busy "
          f"{busy / 1e6:.4f}s = {100 * busy / 1e6 / wall:.2f}% (idle "
          f"{100 * (1 - busy / 1e6 / wall):.2f}%)")

    # 50. the batched entries == their plain versions and B launches of the
    # single-frame entries on the kept calls, timed in turns
    cap = {k: v[1] for k, v in kept.items()}
    rows = {}
    for name, (kern, plain, frames_fn) in level_entry_fns(neighbors, recolor, cap).items():
        out_k, out_p, out_f = kern(), plain(), frames_fn()
        torch.cuda.synchronize()
        err, err_f = max_abs_err(out_k, out_p), max_abs_err(out_k, out_f)
        if err != 0 or err_f != 0:
            raise AssertionError(f"{name}: differs from its plain version ({err}) or from "
                                 f"per-frame launches ({err_f})")
        (k1, k2), (p1, p2) = time_turns(kern, plain, reps_k=20, reps_p=2)
        f1 = time_ms(frames_fn, 20)
        b_ms, b_by = bounds(name, cap[name], out_k)
        print(f"{name}: exact (max abs err {err}; the single-frame entry frame by frame "
              f"equal too); kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, per-frame "
              f"launches {f1:.4f} ms, bound {b_ms:.4f} ms ({b_by}); inputs "
              f"{[tuple(t.shape) for t in cap[name] if torch.is_tensor(t)]}")
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err, library_ms=None)
    return rows, {k: launches[k] for k in LEVEL_KERNELS}

def option_encode(dev, name: str, cfg, frames, rc):
    """A warm-up and, counters at 0, a warm `encode_gof` of one packing
    option, driven by the JAX partitions: prints cold and warm seconds per
    frame, the stage split and the launches of OPTION_PATH (each nonzero),
    requires the stream's md5 and bytes and every frame's reconstruction to
    equal the JAX encoder's and the port's decoder to decode the stream to
    the reconstruction.  Returns (encoder, stream, the warm-up's
    `pack_global` digests, launches)."""
    from vpcc_tpu_torch.core import packing

    n = len(frames)
    real = packing.pack_global
    digests = []

    def spy(frame_patches, *a, **kw):
        out = real(frame_patches, *a, **kw)
        digests.append((packing.placement_digest(frame_patches, out), list(out)))
        return out

    packing.pack_global = spy
    try:
        t0 = time.perf_counter()
        encode_driven(cfg, frames)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) / n
    finally:
        packing.pack_global = real
    dev.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, stream, recon = encode_driven(cfg, frames)
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) / n
    counted = {k: v for k, v in dev.LAUNCHES.items() if v}
    split = {f: sum(getattr(st, f) for st in enc.stats) / n
             for f in ("segmentation_s", "patchgen_s", "packing_s", "occupancy_s",
                       "video_s", "reconstruct_s", "recolor_s")}
    print(f"{name} encode: cold {cold:.4f}, warm {warm:.4f} s/frame (JAX partitions; JAX on a "
          f"CPU {rc['jax_cpu_encode_s'] / n:.4f}); per frame "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"{name} launches on the encode path: "
          + ", ".join(f"{k} {counted.get(k, 0)}" for k in OPTION_PATH) + f" (all: {counted})")
    idle = [k for k in OPTION_PATH if counted.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"{name}: kernels not launched on the encode path: {idle}")
    same = hashlib.md5(stream).hexdigest() == rc["stream_md5"] and \
        len(stream) == rc["stream_bytes"]
    print(f"{name} stream {len(stream)} vs {rc['stream_bytes']} bytes, byte-identical to the "
          f"JAX encoder's: {same}")
    if not same:
        raise AssertionError(f"{name}: the stream differs from the JAX encoder's")
    bad = []
    for i, (e, r) in enumerate(zip(enc.last_encoded, rc["frames"])):
        got = dict(patches=len(e.patches), width=e.width, height=e.height,
                   recon_points=recon[i].point_count,
                   recon_md5=frame_digest(recon[i].positions, recon[i].colors))
        bad += [f"frame {i} {k} {v} (JAX {r[k]})" for k, v in got.items() if v != r[k]]
    if bad:
        raise AssertionError(f"{name}: differs from the JAX package: {bad}")
    print(f"{name} against the JAX package: patches, atlas sizes, reconstructions of all {n} "
          "frames equal")
    _, t_dec, _ = decode_checked(dev, stream, recon, name)
    print(f"{name} decode: {t_dec:.4f} s/frame (JAX on a CPU {rc['jax_cpu_decode_s'] / n:.4f}); "
          "equal to the encoder's reconstruction")
    return enc, stream, digests, {k: counted[k] for k in OPTION_PATH}


def options_cfg(rc):
    from vpcc_tpu_torch.utils.config import VPCCConfig

    cfg = VPCCConfig()
    for k, v in rc["overrides"].items():
        setattr(cfg, k, v)
    return cfg


def gpa_phase(dev, frames):
    """Steps 56-57: global patch allocation on the 8 bench frames at r3.
    Returns (the GPA stream, launches)."""
    ref = json.loads(GPA_TILES_REFERENCE.read_text())["configs"]["gpa"]
    if [f.point_count for f in frames] != [r["source_points"] for r in ref["frames"]]:
        raise AssertionError("gpa: the frames differ from the JAX package's")
    enc, stream, digests, launches = option_encode(dev, "gpa", options_cfg(ref), frames, ref)
    g = ref["pack_global"]
    print(f"gpa data-adaptive choice: {enc.last_gpa_choice} (JAX: {g['choice']}); pack_global "
          f"{g['size'][0]}x{g['size'][1]} over {g['chains']} chains of {g['patches']} patches, "
          f"per-frame maximum {g['per_frame_size'][0]}x{g['per_frame_size'][1]}")
    if enc.last_gpa_choice != g["choice"]:
        raise AssertionError("gpa: the data-adaptive choice differs from the JAX encoder's")
    if not digests or any(dg != (g["digest"], g["size"]) for dg in digests):
        raise AssertionError(f"gpa: pack_global's placements {digests} differ from the JAX "
                             f"package's {g['digest']} {g['size']}")
    print(f"gpa pack_global on the phase-A patches: digest {digests[0][0]} equal to the JAX "
          "package's")
    ad, ad_r3 = unit_bytes(stream)["AD"], unit_bytes(FIXTURE.read_bytes())["AD"]
    print(f"gpa AD substream: {ad} bytes against {ad_r3} for the r3 stream without GPA; "
          f"stream {len(stream)} against {len(FIXTURE.read_bytes())} bytes")
    return stream, launches


def tiles_phase(dev, frames):
    """Steps 58-59: two tiles a frame on the 8 bench frames at r3.  Returns
    launches."""
    from vpcc_tpu_torch.bitstream import v3c

    ref = json.loads(GPA_TILES_REFERENCE.read_text())["configs"]["tiles"]
    if [f.point_count for f in frames] != [r["source_points"] for r in ref["frames"]]:
        raise AssertionError("tiles: the frames differ from the JAX package's")
    enc, stream, _, launches = option_encode(dev, "tiles", options_cfg(ref), frames, ref)
    if (enc._tile_rows, enc._tile_hints) != (ref["tile_rows"], ref["tile_hints"]):
        raise AssertionError(f"tiles: rows {enc._tile_rows}, ratchets {enc._tile_hints} "
                             f"(JAX {ref['tile_rows']}, {ref['tile_hints']})")
    per_tile = [[sum(1 for p in e.patches if p.tile_assigned == t) for e in enc.last_encoded]
                for t in range(2)]
    if [list(x) for x in zip(*per_tile)] != [r["tile_patches"] for r in ref["frames"]]:
        raise AssertionError("tiles: patches per tile differ from the JAX encoder's")
    payload = next(p for t, p in v3c.read_sample_stream(stream) if t == v3c.V3C_AD)
    _, afps, full, ok, _ = v3c.read_atlas_substream(payload)
    if afps.num_tiles_minus1 != 1 or len(ok) != 2 * len(frames) or not all(ok):
        raise AssertionError("tiles: the atlas substream lacks a tile or a good hash SEI")
    for t in range(2):
        _, _, alone, ok_t, _ = v3c.read_atlas_substream(payload, tile_filter={t})
        if len(ok_t) != len(frames) or not all(ok_t) or \
                [len(x.patches) for x in alone] != per_tile[t]:
            raise AssertionError(f"tiles: tile {t} does not parse alone")
    print(f"tiles: rows {enc._tile_rows}, ratchets {enc._tile_hints}, patches per tile "
          f"{per_tile} (= JAX's); each tile parses alone, {len(ok)} hash SEIs good")
    return launches


def apps_phase(dev, frames, gpa_stream):
    """Steps 60-61: the parser on the fixture and the GPA stream;
    apps/encode.py and apps/decode.py on two bench frames, the conformance
    app on their logs; the color converter on the card against the CPU."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from vpcc_tpu_torch.apps import color_converter, conformance as conf_app, decode, encode
    from vpcc_tpu_torch.apps import parser
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.ply import write_ply

    def run(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, stream in (("fixture", FIXTURE.read_bytes()), ("gpa", gpa_stream)):
            path = tmp / f"{name}.vpcc"
            path.write_bytes(len(stream).to_bytes(8, "big") + stream)
            rc, out, _ = run(parser.main, [f"--compressedStreamPath={path}"])
            ad = next((ln for ln in out.splitlines() if "V3C_AD" in ln), "")
            print(f"parser on the {name} stream: rc {rc}; {ad.strip()}")
            if rc != 0 or "hash SEI OK" not in ad or "8 ATLs" not in ad:
                raise AssertionError(f"parser: the {name} stream does not parse:\n{out}")

        for i, f in enumerate(frames[:2]):
            write_ply(tmp / f"src_{i:04d}.ply", f)
        out_path = tmp / "apps.vpcc"
        r3 = ["--geometry3dCoordinatesBitdepth=10", "--resolution=1023", "--geometryQP=24",
              "--attributeQP=32", "--gridBasedSegmentation=1", "--occupancyPrecision=2",
              "--iterationCountRefineSegmentation=10"]
        images = []
        real = Encoder.attribute_images

        def keep_t0(self, *a, **kw):
            out = real(self, *a, **kw)
            if not images:
                images.append(out[0].clamp(0, 255).to(torch.uint8).cpu().numpy())
            return out

        Encoder.attribute_images = keep_t0
        dev.reset_launch_counts()
        try:
            rc_e, out_e, t_e = run(encode.main, [
                "--device=cuda", f"--uncompressedDataPath={tmp}/src_%04d.ply",
                f"--compressedStreamPath={out_path}", "--frameCount=2", *r3])
        finally:
            Encoder.attribute_images = real
        counted = {k: v for k, v in dev.LAUNCHES.items() if v}
        rc_d, out_d, t_d = run(decode.main, ["--device=cuda",
                                             f"--compressedStreamPath={out_path}"])
        print(f"apps/encode.py: rc {rc_e}, {t_e:.2f} s for 2 frames (own segmentation, metrics "
              f"inline; launches {', '.join(f'{k} {counted.get(k, 0)}' for k in OPTION_PATH)}); "
              f"apps/decode.py: rc {rc_d}, {t_d:.2f} s; {out_d.strip()}")
        if rc_e or rc_d or any(counted.get(k, 0) == 0 for k in OPTION_PATH):
            raise AssertionError(f"apps: encode/decode failed:\n{out_e}\n{out_d}")
        rc_c, out_c, _ = run(conf_app.main, [
            f"--encLog={out_path}_enc_pcframe_log.txt",
            f"--decLog={out_path}_dec_pcframe_log.txt"])
        print(f"apps/conformance.py on their logs: rc {rc_c}: {out_c.strip()}")
        if rc_c != 0 or "CONFORMANCE MATCH: 2 frames" not in out_c:
            raise AssertionError("apps: the conformance logs differ")

        rgb = images[0]
        np.save(tmp / "rgb.npy", rgb)
        runs = [("rgb2ycc", "rgb.npy", ".npy", []), ("rgb2ycc", "rgb.npy", ".npz", ["--f420=1"]),
                ("rgb2ycc", "rgb.npy", ".npz", ["--f420=1", "--downsampleFilter=1"]),
                ("ycc2rgb", "cpu_rgb2ycc_1.npz", ".npy", []),
                ("ycc2rgb", "cpu_rgb2ycc_2.npz", ".npy", ["--upsampleFilter=1"])]
        for k, (mode, inp, ext, extra) in enumerate(runs):
            outs, secs = [], []
            for d in ("cpu", "cuda"):
                o = tmp / f"{d}_{mode}_{k}{ext}"
                rc, _, t = run(color_converter.main,
                               [mode, str(tmp / inp), str(o), f"--device={d}", *extra])
                if rc:
                    raise AssertionError(f"color_converter {mode} {extra} on {d}: rc {rc}")
                z = np.load(o)
                outs.append({key: z[key] for key in z.files} if ext == ".npz" else {"": z})
                secs.append(t)
            same = all(np.array_equal(outs[0][key], outs[1][key]) and
                       outs[0][key].dtype == outs[1][key].dtype for key in outs[0])
            print(f"color_converter {mode} {' '.join(extra) or '4:4:4'} on a {rgb.shape} "
                  f"attribute image: the card's output equal to the CPU's: {same} (cpu "
                  f"{secs[0]:.3f} s, cuda {secs[1]:.3f} s a call)")
            if not same:
                raise AssertionError(f"color_converter {mode} {extra}: cuda differs from cpu")


def _library_paint(pix, layer, vals, h: int, w: int):
    """Kernel P's paint as PyTorch calls: the index preparation (tags 0 and
    1 inside the image keep their flat (layer, pixel) index, the others
    point at one spare row, so nothing waits on the host), then one
    `index_put_` into zeroed stacked layer images.  A lower yardstick, not
    the same function: `index_put_` leaves duplicate pixels to whichever
    write lands last (kernel P keeps the highest row) and does no layer-1
    fallback."""
    x, y = pix[:, 0].long(), pix[:, 1].long()
    keep = ((layer == 0) | (layer == 1)) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    flat = torch.where(keep, (layer.long() * h + y) * w + x, 2 * h * w)
    img = torch.zeros((2 * h * w + 1, *vals.shape[1:]), dtype=torch.int32, device=vals.device)
    return img.index_put_((flat,), vals)[:-1]


def _library_gather(pix, layer, a0, a1):
    """Kernel P's gather as PyTorch calls: the pixels clamped into the
    image, both images read by advanced indexing, the point's layer picked
    by `torch.where` (uint8 colors out: no widening to int32)."""
    h, w = a0.shape[:2]
    x = pix[:, 0].long().clamp(0, w - 1)
    y = pix[:, 1].long().clamp(0, h - 1)
    pick = (layer == 1).view(-1, *([1] * (a0.dim() - 2)))
    return torch.where(pick, a1[y, x], a0[y, x])


def p_library_ms(what: str, paint_args, gather_args, gather_plain, clamp: bool):
    """(paint ms, gather ms) of the PyTorch calls that compute what kernel
    P's paint (index preparation, for colors the 0..255 clamp, `index_put_`)
    and gather (clamps, advanced indexing, `torch.where`) do, over 100 calls
    each; timed here, used nowhere in the port.  The gather's result is held
    against the plain version first: it is the same function.  Group
    dilation has no single-call counterpart."""
    pix, layer, vals, h, w = paint_args
    got = _library_gather(*gather_args).to(torch.int32)
    if not torch.equal(got, gather_plain(*gather_args)):
        raise AssertionError(f"{what} library gather differs from the plain version")
    clamped = (lambda: vals.clamp(0, 255)) if clamp else (lambda: vals)
    put = lambda: _library_paint(pix, layer, clamped(), h, w)
    get = lambda: _library_gather(*gather_args)
    t_put, t_get = time_ms(put, 100), time_ms(get, 100)
    try:   # none of these calls waits on the host, so they can be captured
        dev_txt = f"device {graph_ms(put):.4f} / {graph_ms(get):.4f} ms (CUDA graph replay)"
    except RuntimeError as e:
        dev_txt = f"device not measured ({type(e).__name__}: {str(e)[:120]})"
    print(f"{what} library (index preparation included): paint by index_put_ {t_put:.4f} ms, "
          f"gather by advanced indexing {t_get:.4f} ms; {dev_txt}")
    return t_put, t_get


def eom_library_ms(ex_args, in_args) -> float:
    """Library ms of kernel S: boolean-mask indexing for the extract and
    masked assignment for the inject, the masks included (timed here, used
    nowhere in the port).  The inject's equality holds while the aux rows
    cover the EOM rows, as on the main path."""
    layer, col = ex_args
    layer2, col2, aux = in_args

    def both():
        out = col2.clone()
        m = layer2 == 2
        out[m] = aux[:int(m.sum())].to(col2.dtype)
        return col[layer == 2], out

    t = time_ms(both, 20)
    print(f"eom_colors library: mask indexing + masked assignment {t:.4f} ms")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from vpcc_tpu_torch import device as dev

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = dev.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f}s wall "
          + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for name, log in dev.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
    smem = dev.load_kernel("wavefront_encode32").wavefront_encode_smem
    print(f"kernel I dynamic shared memory a block: {smem(0)} bytes (32/16/8), "
          f"{smem(1)} bytes (two-level)")

    rows, launches, decoded = decode_phase(dev)
    front_rows, front_launches, (cfg, frames, segs) = front_phase(dev)
    geo_rows, geo_launches = geometry_phase(dev, cfg, frames, segs)
    enc_rows, enc_launches, r3 = encode_phase(dev, cfg, frames, segs)
    met_rows, met_launches = metrics_phase(dev, cfg, frames, segs, decoded, r3)
    vox_rows, vox_launches, vox_frames = vox11_phase(dev)
    ll_rows, ll_launches = lossless_phase(dev, frames)
    tools_rows, tools_launches = tools_phase(dev, frames)
    ao_rows, ao_launches = attr_options_phase(dev, frames)
    so_rows, so_launches = seg_options_phase(dev, frames)
    lv_rows, lv_launches = level_phase(dev, cfg, frames, segs, r3[0])
    g11_rows, g11_launches = geo11_phase(dev, vox_frames)
    del vox_frames
    gpa_stream, _ = gpa_phase(dev, frames)
    tiles_phase(dev, frames)
    apps_phase(dev, frames, gpa_stream)
    rows.update(front_rows)
    rows.update(geo_rows)
    rows.update(enc_rows)
    rows.update(met_rows)
    rows.update(vox_rows)
    rows.update(ll_rows)
    rows.update(tools_rows)
    rows.update(ao_rows)
    rows.update(so_rows)
    rows.update(lv_rows)
    rows.update(g11_rows)
    launches = {**{k: launches[k] for k in DECODE_KERNELS}, "sao_apply": launches["sao"],
                **{k: front_launches[k] for k in FRONT_KERNELS},
                **{k: geo_launches[k] for k in GEOMETRY_KERNELS},
                **{k: enc_launches[k] for k in ENCODE_KERNELS + E_ENCODE_ROWS},
                **{k: met_launches[k] for k in METRICS_KERNELS},
                **{k: vox_launches[c] for k, c in VOX11_ROWS.items()},
                **{k: ll_launches[k] for k in LOSSLESS_KERNELS},
                **tools_launches, **ao_launches, **so_launches, **lv_launches,
                **g11_launches}

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
