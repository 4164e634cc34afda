#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. build   -- compile the port's CUDA kernels with nvcc (one process per source);
2. device  -- the card's name and power limit, as nvidia-smi reports them;
3. b1      -- the ScanU/ScanUL1 tile-scan kernel against its plain version at (4, 2^24);
              one launch at and around the edge of its CTA groups (rows of 1, G - 1,
              G, G + 1 and 3 G + 17, batches of 1 and 64, s = 8, 16 and 128),
              exact; five repeated fp32 calls bit-equal; the CTAs a launch ran;
4. b7      -- the radix-16 pass chain on (4, 128256) bf16 and fp32 keys, exact; one
              pass at and around the tile split's edge (rows of 1, TILE - 1, TILE,
              TILE + 1 and 3 TILE + 17 keys, batches of 1 and 64, 1-, 4- and 8-bit
              digits of 8-, 16- and 32-bit keys), exact and one launch a pass;
5. b8      -- the fused top-p tail at (4, 128256): on every row within the window
              of indices that the stated band allows, and exact where that
              window holds one index; then at the rows of B8_ROWS (1 to 257216
              in one round of its cluster, 2^20 in rounds) the same, and equal to
              its model (``split_mm._topp_tail_cluster``) and over five more
              calls, one launch each;
6. b2b4    -- the §4 pipeline's block sums, carry scan and block scan each against
              their plain versions at (4, 2^24), and the fused block sums and
              carries (one launch) against B2 alone and B3 on its sums, bit for bit
              (five fp32 calls bit-equal), then the whole pipeline (two launches)
              on a ragged row and on a one-block row (where B2 and B3 must not
              launch), and the fused launch on int8 rows off 16-byte alignment;
7. b5      -- SplitInd against its plain version and a stable argsort, exact, one
              launch a call; at and around the edge of its tiles (rows of 1, TILE - 1,
              TILE, TILE + 1 and 3 TILE + 17, batches of 1 and 64, every word size,
              flags of 1, 2 and -1) and on a payload and flags off 16-byte alignment;
8. seg     -- the segmented scan kernels (B9-B12) each against its plain version at
              (4, 2^24) on rows cut into segments of log-uniform length (empty
              ones included), then the segmented scans on a ragged row, a
              one-block row (where B10 and B11 must not launch) and the
              sampler's (16, 513024) one-hot rows over one row of flags; B9 at and
              around the edge of its tiles (as b1's rows, flags spanning tiles,
              on each tile's first element, none, all, random and one row shared),
              exact and one launch each; five repeated fp32 calls bit-equal; the
              sampler's single (1, 513024) scan; the CTAs a launch ran; B10's five
              repeated fp32 calls bit-equal and equal to the fold in the kernel's
              order, and its run and block edges (ragged rows, flags on each run's
              first or last element, none, all, each block's last, random, per row
              and shared), one launch each; B11 at one tile (nb = 128, 8192) and
              over many (8193, 70001, 2^20: the look-back, CTAs counted), int32
              exact, fp32 within 16 ulp and five calls bit-equal, one launch each;
9. linrec -- the linear-recurrence kernels (B13-B16) each against its plain version
              at (4, 2^24) on random, integer-valued and a = 1 rows (ints exact and
              equal to an fp64 reference; random fp32 within 16 ulp of the fp64
              recurrence, a bf16-operand control failing that limit), B14 + B15 in
              one launch bit-equal to B14 and to B15 on its summaries (also at one
              tile a block, 65536 blocks a row; five fp32 calls bit-equal), then a
              ragged row, a one-block row (where B14 must not launch; B15 never
              launches on the pipeline, its walk runs in B14's launch), the
              SSD's (4, 16, 64, 64, 64) shape along axis 1 (the column walk of B13
              and B16: one launch, exact on integer values against its plain
              version and fp64, random fp32 within 16 ulp, five repeated calls
              bit-equal; the same pairs as 2^20 rows of 16 on B13's and B16's
              warp walks, within the same limits), and cumprod,
              segment_linear_scan and cummax on the kernel
              methods; B13's single pass at and around the edge of its tiles (as
              b1's rows), exact and one launch each, at (1, 2^26) and (64, 2^20)
              (one CTA a tile, exact), and five repeated fp32 calls bit-equal;
10. guards -- the non-finite policies through the public entry points at (4, 2^24),
              the inputs poisoned by ``analysis/faults.py`` ``inject_nonfinite``
              (NaN, +inf, -inf): ``scan``, ``segment_scan``, ``linear_scan`` and
              ``segment_linear_scan`` on "kernel" (B1, B9, B13) and "blocked" (B2-B4,
              B10-B12, B14-B16):
              ``raise`` refuses with every launch counter at 0, ``sanitize`` is
              finite and bit-equal to the same method on the identity-filled input
              with the same launches, ``propagate`` puts NaN and ±inf exactly where
              the reference stated in ``PROPAGATE_REF`` does (finite elements within
              16 ulp of fp64); ROADMAP Queue C's overflow rows (``a ≡ 2``, ``b ≡ 1``
              and ``b ≡ 0``; 300 long and (4, 2^24); the column walk at the SSD's
              shape, also with ``a ≡ 512``), their first inf and NaN steps equal to
              ``OVERFLOW_REF``'s reference; the samplers at (4, 128256) (a clean, a
              half-masked, a fully masked and a NaN-poisoned row) through
              ``top_p_sample`` (B7 + B8), ``segment_top_p_sample`` (B9) and
              ``weighted_sample`` (B1) on "kernel": greedy tokens for the poisoned
              rows under ``sanitize``, window-held tokens for the others, ``raise``
              refusing the four rows and passing the first two; each policy's ms;
              ``guards_serving`` (after ``serve_continuous``, on its weights and
              trace): a greedy ``ContinuousEngine`` run under ``guards.checks()``
              identical to the unchecked run (ms and host syncs a tick beside each
              other), the page-budget guard firing on a row placed past its budget,
              and ``ServeEngine(sampler="topp_kernel")`` under
              ``nonfinite_override("sanitize")`` with the tokens and B7/B8 launches
              of the run without it;
11. main   -- the main paths with the launch counters zeroed before and read
              after each: ``scan(method="kernel")`` and ``scan(method="blocked")``
              at (4, 2^24), ``compress`` with ``method="kernel"`` and
              ``"blocked"``, ``segment_compress`` with both, ``linear_scan`` with
              both (``main_linrec``), and ServeEngine (``sampler="topp_kernel"``,
              ``"topp_blocked"``, then ``"topp_segmented"`` under
              ``method_override("kernel")`` and ``("blocked")``, with
              ``sample_packed`` on a ragged batch) on llama3-8b at full width,
              32 layers, bf16;
12. auto   -- ``method="auto"`` on the table's ``"cuda"`` backend, with
              ``AutotuneFallbackWarning`` an error for the whole run: (a) the table is
              valid, its "cuda" backend covers ``TUNED_OPS`` and ``build_table`` on the
              committed ``cuda_sweep.json`` reproduces it (the sweep's card printed
              beside this one); (b) every tuned op and alias (the ``dist_*`` ones
              resolved only), every dtype of its family in the table, at each
              breakpoint and inside each bucket (at most 2^24 elements a call): the
              default call resolves to the table's method, launches what the call
              with that method given explicitly launches, and is bit-equal to it;
              (c) at eight spot points every method and the default, eager, in turns:
              the default within 4x of the fastest (JAX's ``--auto-factor 4`` gate);
              (d) after ``main``'s serving, ``ServeEngine(sampler="topp_auto")`` for
              4 decode steps on its weights: the method it resolved, its launches and
              tokens equal to the explicit sampler's, every token in the band's window;
13. precision -- ``precision="compensated"`` and ``"fast"`` (after ``auto``): ``scan``,
              ``segment_scan``, ``linear_scan`` and ``segment_linear_scan`` on "kernel"
              and "blocked" at (4, 2^24) fp32 and ``ssd_scan`` on "kernel" at zamba2's
              shapes launch what "highest" launches and return its bits (the CUDA
              kernels form no triangle), each within ``ulp_bound(precision, n)`` of
              fp64, integer-valued rows exact; the "matmul" method at (4, 2^20), where
              the split runs, within each bound, integer-valued rows exact under
              "compensated", "fast" further than twice "highest"'s bound from
              "highest", the three precisions' eager ms side by side, and at
              (2, 2^14) each precision within twice "highest"'s bound of the same
              call on the CPU; the phase draws from its own generator;
              ``split_f16`` bit-equal on the card and the CPU (extreme, subnormal,
              fp16-overflow, zero and non-finite rows) and exact for 22-bit
              mantissas; the resolution chain on ``method="auto"`` calls (the
              table's "vector" giving ``torch.cumsum``'s bits under every precision,
              its "kernel" launching B1, ``precision_override`` and
              ``REPRO_SCAN_PRECISION`` reaching a call, an explicit "vector" with
              "fast" raising); and in ``dist``'s world of 2, ``dist_linear_scan`` and
              ``dist_segment_scan`` on "kernel" under "compensated";
14. ssd    -- ``ssd_scan`` at zamba2's shapes on "kernel" (B1 + B13) and "blocked"
              (B4 + B16) against "vector" and the fp64 sequential oracle;
15. serve_zamba2 -- zamba2-1.2b at full width and depth (38 layers, bf16) serving
              batch 4, prompt 2048, 32 new tokens with ``topp_kernel`` under
              ``scan_method="kernel"`` and ``"blocked"``, exact launch counts;
16. b6     -- the multi-way split kernel against its plain version at (4, 2^24),
              R = 16, exact; at R = 256 and R = 10 against a stable argsort and a
              bincount; a ragged row, R = 1, empty buckets, out-of-range digits,
              bf16, int32 and int64 payloads, R = 511 and 512 on either side of the
              tile split's ceiling, R = 5000; the dist phase's vocab shards; one
              launch at and around the edge of its tiles, exact;
17. b17    -- the SSD chunk kernel against its plain version and the fp64 oracle at
              zamba2's shapes: the ``ssd`` inputs, zamba2's init decays, a ragged S;
              its chunk-parallel pass: five repeated calls bit-equal, a CUDA-graph
              replay equal to the eager call, S of 1, Q - 1, Q, Q + 1 and 3Q + 17
              (one CTA a chunk), a chain of 256 chunks;
18. main_multisplit -- ``multi_split(method="kernel")`` at (4, 2^24), R = 16: one
              B6 launch and nothing else;
19. forward_zamba2 -- zamba2-1.2b (38 layers, bf16) ``forward`` and ``loss`` on
              4 x 2048 tokens under each ``scan_method``: 38 B17 launches a pass on
              "kernel", 38 B4 + 38 B16 on "blocked", none on "vector"; the SMOKE
              model's fp32 forward on the card against the CPU, and against B17's
              plain version on two inputs (one the card tests'); its ``ce`` under
              "kernel" and "blocked" within ``ZAMBA2_CE_TOL`` of "vector"'s, two
              faults planted in the chunk's log-decay cumsum reading above it;
20. train  -- zamba2-1.2b trained at full width and depth (fp32 params and AdamW
              state, bf16 compute, remat, ``scan_method="auto"``, batch 4 x 2048
              from ``SyntheticLM``, AdamW as ``launch/train.py`` sets it): exactly
              38 x 3 B16 column walks a step (forward, remat recompute, adjoint)
              and nothing else, the losses finite and falling, step ms, tokens/s,
              peak memory and the B16 launches' device time (a profiled step); the
              first batch's gradients on "vector" (no launch) within
              ``TRAIN_GRAD_TOL`` of "auto"'s (also with slow decays, bf16 and
              fp32); a "kernel" step
              refused before any launch; ``linear_scan``'s adjoint on "kernel" (B13)
              and "blocked" (B14-B16) at rows of (4, 2^20) and (4, 2^24) and on one
              Mamba2 layer's real cross-chunk pairs (B13's and B16's column walks):
              (ā, b̄) within ``ADJ_A_ULP`` / ``ADJ_B_ULP`` of fp64 "vector" autograd,
              the same bits over five calls, one launch set a backward pass, the
              adjoint's ms beside the forward's; the SMOKE model stopped at a
              checkpoint and resumed by a fresh trainer, its last loss bit-equal to
              the uninterrupted run's or within the spread of two such runs;
21. models -- the families of ROADMAP Queue A items 7.1 and 7.2 at full width, bf16,
              random weights from seed 0, each model freed before the next:
              (a) deepseek-moe-16b (arXiv:2401.06066; 28 layers, 1 dense + 27 MoE of
              64 experts top-6) serving batch 4, prompt 128, 32 new tokens with
              ``topp_kernel`` under ``scan_method="kernel"`` (27 B9 a pass: the MoE
              dispatch's exclusive int8 mask scan, one segmented scan a layer) and
              ``"blocked"`` (27 B12: every one-hot row is one block, so B10 and B11
              do not launch), plus 4 B7 + 1 B8 a token, every token in its window;
              (b) its ``forward`` / ``loss`` on 4 x 2048 tokens under "kernel",
              "blocked" and "vector": 27 B9, 27 B12 and no launch a pass, the logits,
              ``ce`` and ``aux`` bit-equal across the three; one layer's real routing
              dispatched in both modes (B9, B1; B12, B4) bit-equal to an int64
              cumsum, B9 and B12 equal to B9's plain version on its one-hot, and the
              dispatch's ms beside the expert GEMMs'; (e) ``ContinuousEngine``
              (greedy, the dispatch on "kernel") on a 4-request Poisson trace, every
              decode step's logits bit-equal to ``DenseReplay``, one B9 a MoE layer
              a prefill and a decode step; (c) llama4-scout-17b-16e at full width,
              2 of its 48 layers (``"reduced"``), serving 8 new tokens on "kernel"
              (2 B9 a pass); (d) qwen3-4b (qk-norm) and gemma2-2b (local/global
              layers, window 4096) at full depth serving ``topp_kernel``, gemma2 at
              batch 2 and a prompt of 4160, and a local layer's ``attn_decode`` and
              ``attn_decode_paged`` at position 4173 bit-equal after the cache
              outside the window is overwritten;
22. families -- the last four families at full width and depth, bf16 weights from seed
              0, each model freed before the next: (a) xlstm-350m (arXiv:2405.04517; 24
              layers, 18 mLSTM + 6 sLSTM, heads of 512): ``forward`` / ``loss`` on 4 x 2048
              tokens under "kernel" (36 B1 + 36 B13 a pass: two chunked SSD scans a mLSTM
              layer, their cross-chunk states on B13's column walk), "blocked" (36 B4 + 36
              B16) and "vector" (none), each warmed up, each ``ce`` within ``XLSTM_CE_TOL`` of
              "vector"'s, one sLSTM layer's ms alone (a Python loop over time); one
              mLSTM layer's real inputs in fp32 on "kernel" (2 B1 + 2 B13) and
              "blocked" (2 B4 + 2 B16): ``mlstm_chunked``'s two ``ssd_scan`` outputs
              within ``SSD_REL``·max|y| of ``ssd_scan_ref`` in fp64 and the cell within
              the bound those give of ``mlstm_ref`` in fp64, and B13's and B16's column
              walks at (4, 16, 4, 512, 512) against their plain version and timed;
              ``ServeEngine(sampler="topp_kernel")`` at batch 4, prompt 128, 32 new
              tokens on "kernel" and "blocked" (a prompt of one chunk: 36 B1, or 36 B4,
              a prefill and no recurrence launch; a decode step none); in fp32, a
              prefill of 4 x 128 and 8 greedy decode steps against the forward over the
              same 136 tokens at full width on 4 layers, within ``XLSTM_DECODE_TOL`` on
              each of 4 seeds, with two faults planted in the prefill's state reading
              above it (at 24 layers the random stack amplifies the cell epsilon's
              share past use: printed, and the prefill held to the forward over its
              own tokens);
              (b) minicpm3-4b (hf:openbmb/MiniCPM3-4B; 62 MLA layers) serving
              ``topp_kernel``, and one layer's absorbed ``mla_decode`` at position 128
              within ``MLA_TOL`` of the expanded ``mla_full``'s last row, fp32; (c)
              whisper-small (arXiv:2212.04356; 12 + 12 layers) with a (4, 1500, 768)
              ``enc_embed``, prompt 32, 32 new tokens, the ``xkv`` cache bit-equal after
              32 decode steps, one ``forward`` / ``loss``; (d) paligemma-3b
              (arXiv:2407.07726; 18 layers, MQA, vocab 257216) with a (4, 256, 2048)
              ``img_embed``: serving, the prefix mask on one layer's ``attn_full`` (image
              outputs bit-equal after the last text token changes, the first image
              output moved by the last image token) and ``loss`` on the text positions
              only; every sampled token inside its band's window;
23. b7h    -- the radix pass that exports its histogram against its plain version at
              (4, 2^22) int32 keys (one shard of a 2^24 row at D = 4): every shift of
              the 8 radix-16 passes, chained into a stable sort; a ragged row and
              16-bit keys; the tile-edge cases of ``b7``; keys, permutation and counts
              exact, counts equal to a bincount of the digits;
24. dist   -- the distributed operators in gloo worlds of 4 and of 2 ranks on the one
              card (a process a rank): dist_sort / dist_topk (method="kernel") of
              (4, 2^24) fp32 and bf16 keys bit-equal to the local kernel sort, exactly
              8 (fp32) or 4 (bf16) B7h launches a rank and no B7; dist_top_p_sample
              (method="kernel") on (4, 128256) logits, exactly 4 B7h + 4 B6 + 2 B1 a
              rank, every token inside the band's window; mcscan, dist_linear_scan
              and dist_segment_scan on "kernel" and "blocked" at (4, 2^24) under the
              single-device phases' limits; in the world of 2, dist_top_p_sample
              (method="kernel", nonfinite="sanitize") on the guards phase's sampler
              rows, the poisoned rows' greedy tokens; every call's collective calls
              and bytes equal to modeled_dist_traffic;
25. serve_sharded -- ServeEngine(sampler="topp_sharded") on llama3-8b at full width
              and depth (bf16, random weights from seed 0), batch 4, prompt 128, 32
              new tokens, in a world of 2 ranks on the card: the same stream on both
              ranks, every token inside the window of the solo sampler, the decode
              step's ms and collectives;
26. mesh   -- two worlds of 2 ranks sharing the card (``phase_mesh``): ``train_dp``,
              zamba2-1.2b at full width, its depth cut 38 -> 12 (a multiple of its
              shared-attention interval; two ranks of 38 layers do not fit), trained
              by ``Trainer(mesh=)`` on a (2 data, 1 model) grid (fp32 state, bf16
              compute, remat, "auto", 4 x 2048 SyntheticLM tokens, 5 steps): exactly
              36 B16 a step a rank and no other launch, the losses finite and
              falling, one gradient all-reduce a step equal to
              ``modeled_dp_step_traffic``, ``compressed_grad_sync`` on step 1's
              gradients within 5% of the fp32 mean, and in fp32 at 6 layers on one
              row a rank the synced gradients and first loss against one rank's
              ``Trainer`` on both rows (run here after the world exits), with the
              summed gradient planted above the limit, and the world's checkpoint
              restored here bit for bit; step ms, tokens/s, peak GB and the
              all-reduce's ms a rank; ``serve_ep``, deepseek-moe-16b at full size in
              bf16 on a (1 data, 2 model) grid, each rank holding 32 of each layer's
              64 experts: ``ServeEngine`` greedy and ``topp_sharded`` at batch 4,
              prompt 128, 16 new tokens on "kernel": exactly 27 B1 a pass a rank (the
              expert-parallel dispatch's mask scan) and no other launch, both ranks'
              streams equal, collectives equal to ``modeled_ep_traffic`` (and the
              sampler's ``modeled_dist_traffic``), the prefill's logits against the
              one-rank model's (here) within ``EP_LOGIT_TOL`` with the other rank's
              part dropped planted above it; prefill and decode ms, peak GB a rank;
27. dryrun -- ``launch/dryrun.py``'s record of zamba2-1.2b x long_500k on a 1 x 1 grid
              (fp32 params, bf16 caches of 524288 positions: ~30.2 GB predicted),
              then that cell allocated on the card (``init`` and the hybrid
              ``empty_caches``): the growth of ``memory_allocated`` within
              ``DRYRUN_TOL`` of the prediction; one ``decode_step`` at position
              524287 with finite logits, its ms and the peak GB beside the
              prediction;
28. examples -- each ``examples/torch_*.py`` ``main()`` in-process on the card at the
              small arguments of ``EXAMPLES``, every check it prints holding; its
              launches count in the kernels line;
29. timing -- kernel, plain-version and library times beside each kernel's bound, and
              dist_sort's ms at D = 2 and 4 (gloo over loopback: the transport's time,
              not NCCL's).  The B7 chain, a pass and the torch.sort beside them, B1,
              B9 and B9's (1, 513024) sampler scan are timed as eager calls, as every
              other row, and as CUDA graph replays (their device time, under names of
              their own), as are B5 at both shapes and B10; B1 and B9 beside their
              pipelines; B6 at
              R = 10, 16 and 256 and at the vocab shards (eager and graph), B13 at
              (4, 2^24) (eager and graph), its dist shards, B13 and B16 on the SSD's
              column walk beside the row path before it and the whole axis-1
              ``linear_scan`` call, B16 at the shards, B17 beside its bytes,
              tensor-core and fp32 bounds; B8 as a graph replay at (4, 128256)
              with its design options (threads a CTA, CTAs a cluster) and at
              (4, 2^20); B11 at (4, 128) and (4, 2^20), eager and graph; the
              launch floor (one ``zero_()`` of 4 elements, eager and graph);
              B2, B3, B4, B12, B14 and B15 as graph replays (B2-B4 and the
              pipeline at fp32, int8 and bf16; B2 + B3 in one launch beside B2
              then B3, also at 65536 blocks a row; B14 + B15 in one launch beside
              B14 then B15 at 128, 256, 512, 1024 and 65536 blocks a row, and the
              linear-recurrence pipeline as a graph replay); and
              ``top_p_sample(method="kernel")`` as a graph replay; then, after the
              kernels line's checks, one
              ``launches_by_shape`` line: B6's, B13's, B16's and B17's launches by
              the shape they ran at, beside their ms and bound there.

The ranks of the worlds start as fresh interpreters (``repro_torch.launch.world``)
after the parent has built every kernel; each rank zeroes its counters just before
each call it checks and sends its counts back.  NCCL refuses two ranks on one GPU,
so the worlds run on gloo, which stages the card's operands through host memory.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, so the run exits non-zero and prints no result.  Without a
CUDA device, or without the repository's ``src/repro_torch`` beside this file, it
exits non-zero at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 on the tensor cores, dense
SCAN_SHAPE = (4, 1 << 24)
VOCAB_ROWS = 4
SERVE = dict(batch=4, prompt=128, new=32, seed=0)
# B1's fp32 error limit, in ulps at the prefix scale (analysis/ulp.py).  The
# kernel and its plain version read under 2 ulp at (4, 2^24); a tile scan that
# rounds its operands to TF32 or bf16 reads thousands (the phase's controls
# show it on the same input), so 16 tells true fp32 from either.
B1_F32_ULP = 16.0
RAGGED_N = (1 << 24) - 12345        # a row whose last block is partial
VOCAB = 128256                      # llama3's vocabulary: one block at s=128, 8 tiles
SEG_MAX_LEN = 1 << 20               # segment lengths are log-uniform in [1, 2^20]
SEG_SEED = 13
SSD_ROWS = (4, 16, 64, 64, 64)      # the SSD's cross-chunk states at zamba2's prefill
SSD = dict(batch=4, seq=2048, heads=64, head_dim=64, state=64, chunk=128)
ZAMBA = dict(batch=4, prompt=2048, new=32, seed=0)
# ssd_scan's "kernel" and "blocked" against "vector" on the card, in units of max|y|:
# 4.0e-7 was read at zamba2's shapes, so 2e-6 keeps a 5x margin
SSD_REL = 2e-6
PACKED_ROWS = (VOCAB, 32000, 0, 50257)   # sample_packed: ragged logit rows, one empty
B6_BUCKETS = 16                     # multi_split's radix-16 pass width
SSD_RAGGED_S = 2000                 # B17 on a sequence whose last chunk is partial
FORWARD = dict(batch=4, seq=2048, seed=0)
B7H_SHAPE = (4, 1 << 22)            # one shard of a (4, 2^24) sort at D = 4
LINREC_PROGRESS_SHAPES = ((1, 1 << 26), (64, 1 << 20))   # 8192 B13 tiles each
DIST_SHAPE = (4, 1 << 24)           # the distributed operators' global rows
DIST_WORLDS = (4, 2)
DIST_SEED = 21
DIST_TIMEOUT = 420                  # seconds for one world, startup included
SERVE_SHARDED = dict(ranks=2, **SERVE)
# continuous batching (serve_continuous): 128 allocatable pages of 16 hold fewer
# full-length (512-position) requests than the 8 rows, so admission waits on pages
CONTINUOUS = dict(max_batch=8, page_size=16, n_pages=129, max_len=512, tick_tokens=8)
# 12 requests, not 24: on the H100 the phase took 189 s at 24 and 180 s at 16
# (PERF.md); 12 still fill the pool (128 of 128 pages) and wait on it 4 times
CONT_TRACE = dict(n_requests=12, rate=0.25, prompt_len=(32, 384), max_new=(8, 64), seed=17)
CONT_SAMPLERS = ("greedy", "topp_scan")
CONT_KERNEL_ALLOC = "topp_scan"     # the run whose page allocator is method="kernel" (B5)
CONT_PROFILE_TICK = 5               # the warm-up tick traced with torch.profiler
# B8 off the sampler's shape: rows on and around the 16-byte words of its slices,
# zamba2's and llama3's vocabularies and their shards, paligemma's, and a row of
# 2^20 that the cluster walks in rounds
B8_ROWS = (1, 2, 7, 8, 9, 4096, 32000, 64128, 128255, 128256, 128257, 257216, 1 << 20)
# B11 at one tile (the pipeline's nb = 128, 8192) and over many (look-back)
B11_ROWS = (128, 8192, 8193, 70001, 1 << 20)
B11_LARGE = (4, 1 << 20)            # B11 timed where the look-back works
# models: deepseek-moe-16b serving and forward (its MoE layers' dispatch is the
# paper's int8 mask scan), llama4-scout cut to 2 of its 48 layers (~109 B
# parameters do not fit one card), qwen3-4b and gemma2-2b at full size; gemma2's
# prompt of 4160 reaches past its local layers' window of 4096
MODELS_SERVE = dict(batch=4, prompt=128, new=32, seed=0)
MODELS_FORWARD = dict(batch=4, seq=2048, seed=0)
SCOUT = dict(layers=2, batch=4, prompt=128, new=8)
QWEN = dict(batch=4, prompt=128, new=32)
GEMMA = dict(batch=2, prompt=4160, new=16)
MOE_CONTINUOUS = dict(max_batch=4, page_size=16, n_pages=37, max_len=144, tick_tokens=8)
MOE_TRACE = dict(n_requests=4, rate=0.25, prompt_len=(32, 128), max_new=(8, 16), seed=17)
# families: xlstm-350m, minicpm3-4b, whisper-small and paligemma-3b at full size
FAMILY_SEED = 0
FAMILY_SERVE = dict(batch=4, prompt=128, new=32)
XLSTM_FORWARD = dict(batch=4, seq=2048, seed=0)
XLSTM_DECODE = dict(batch=4, prompt=128, steps=8, layers=4, seeds=(0, 1, 2, 3))
# xlstm's forward ce under "kernel" and "blocked" against "vector"'s, bf16 at full
# depth: the float scans round differently and the random stack amplifies it
# (the cell's normaliser nearly cancels); an H100 (700 W) read 5.3e-3 on both
# methods.  The scans themselves are held by the mLSTM cell check.
XLSTM_CE_TOL = 2e-2
# xlstm fp32 prefill + decode against the forward, 4 layers at full width: the
# chunked pass shifts the cell by the sequence's max input gate, the replay and
# the steps by the running max, which cancel but for the cell's epsilon's share of
# the small normalisers.  The limit lies between the sound readings over
# XLSTM_DECODE's seeds (an H100 at 700 W: 1.6e-3 to 1.04e-2) and those of the
# faults planted in XLSTM_FAULTS (0.35 and 3.4), and each run checks that both
# faults still read above it
XLSTM_DECODE_TOL = 5e-2
# the prefill's last logits against the forward over the same prompt: the same
# chunked arithmetic
XLSTM_PREFILL_TOL = 1e-4
MLA_POS = 128
# MLA absorbed decode against the expanded row, fp32, relative to the row's max: the
# same products summed in another order (r = 256 latent terms against dn = 64)
MLA_TOL = 1e-4
WHISPER = dict(batch=4, prompt=32, new=32, forward_len=448)
# relative fp32 rounding allowed on top of the ce of a text-only loss (the VLM's
# check): a few roundings of each ~10-nat term and a tree sum
CE_SLACK = 1e-5
# zamba2's forward ce under "kernel" and "blocked" against "vector"'s, bf16 at full
# depth on 4 x 2048 tokens: the float scans round differently and bf16 carries it
# through 38 layers.  An H100 (700 W) read 3.29e-3 (kernel) and 2.41e-3 (blocked);
# faults planted in the chunk cumsum read 1.84e-2 (10% short), 1.20e-2 (zeroed),
# 1.83e-2 (doubled), but 5.9e-3 (off by one token) and 4.7e-3 (1% short): at
# random weights the ce sees only coarse faults of the scans.  Each run checks
# that the faults of ZAMBA2_FAULTS still read above the limit
ZAMBA2_CE_TOL = 8e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def expect_counts(counts, what: str, **want) -> None:
    """Every kernel's launch count is ``want``'s (0 where it names none)."""
    full = {k: want.get(k, 0) for k in ops.KERNELS}
    check(counts == full, f"{what}: expected launches {full}, got {counts}")


def fused_walks(what: str, want: int, key: str = "block_sums_carries") -> int:
    """The fused launches since the counters were zeroed: B2 + B3 (counted under
    ``block_sums``, and apart under ``block_sums_carries``: B3's walk ran in each), or
    with ``key="linrec_summaries_carries"`` B14 + B15 (under ``linrec_summaries``)."""
    got = _build.LAUNCHES[key]
    check(got == want, f"{what}: expected {want} fused {key} launches, got {got}")
    return got


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _startup():
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this run needs one GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isfile(os.path.join(src, "repro_torch", "__init__.py")):
        sys.exit("chip_smoke: src/repro_torch is not beside this script; run it from "
                 "a checkout of the repository")
    sys.path.insert(0, src)
    return torch


torch = _startup()
import numpy as np  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.analysis import ulp  # noqa: E402
from repro_torch.analysis.faults import inject_nonfinite  # noqa: E402
from repro_torch.analysis.collectives import (modeled_dist_traffic,  # noqa: E402
                                              modeled_dp_step_traffic, modeled_ep_traffic,
                                              sum_forms)
from repro_torch.analysis.streams import (DenseReplay, first_divergence,  # noqa: E402
                                          step_margin)
from repro_torch.core import autotune, comm, guards  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core import segmented as segm  # noqa: E402
from repro_torch.core.autotune import AutotuneFallbackWarning, method_override  # noqa: E402
from repro_torch.core.dist_ops import (dist_linear_scan, dist_segment_scan,  # noqa: E402
                                       dist_sort, dist_top_p_sample, dist_topk)
from repro_torch.core.distributed import mcscan  # noqa: E402
from repro_torch.core.linrec import cummax, cumprod, linear_scan  # noqa: E402
from repro_torch.core.precision import ENV_VAR as PRECISION_ENV  # noqa: E402
from repro_torch.core.precision import (PRECISIONS, SPLIT_SHIFT, ldexp,  # noqa: E402
                                        precision_override, split_f16)
from repro_torch.core.primitives import (compress, multi_split, radix_sort,  # noqa: E402
                                         top_p_sample, weighted_sample)
from repro_torch.core.scan import accum_dtype_for, scan  # noqa: E402
from repro_torch.core.scan import cumsum as prim_cumsum  # noqa: E402
from repro_torch.core.segmented import (SegmentedBatch, boundary_flags,  # noqa: E402
                                        segment_compress, segment_linear_scan,
                                        segment_scan, segment_top_p_sample)
from repro_torch.core import linrec as linrec_core  # noqa: E402
from repro_torch.core import ssd as ssd_core  # noqa: E402
from repro_torch.core.ssd import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.kernels import (_build, linrec_mm, lookback, ops,  # noqa: E402
                                 scan_mm, scan_pipeline, segscan_mm, split_mm, ssd_chunk)
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import attention as att_model  # noqa: E402
from repro_torch.models import mamba as mamba_model  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.models import xlstm as xlstm_model  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.model import build_model, get_config  # noqa: E402
from repro_torch.serving import paged_kv  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, poisson_trace  # noqa: E402
from repro_torch.tools import sweep, tune  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.grad_compression import (compressed_grad_sync,  # noqa: E402
                                                   init_errors)
from repro_torch.training.optimizer import AdamWConfig, tree_leaves  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402
from repro_torch.utils import sharding  # noqa: E402
from repro_torch.utils.sharding import Grid  # noqa: E402

DEV = torch.device("cuda")


def sync():
    torch.cuda.synchronize(DEV)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after a warm-up."""
    fn()
    sync()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` captured once in a CUDA graph and replayed ``reps``
    times: the kernels back to back with no host work between them.  For calls whose
    host time (Python, allocation, launches) exceeds their device time."""
    side = torch.cuda.Stream(DEV)
    side.wait_stream(torch.cuda.current_stream(DEV))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(DEV).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def paired_ms(kernel, plain, reps: int, kernel_reps=None):
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain); the
    kernel over ``kernel_reps`` calls where the plain version is too slow for as
    many."""
    kreps = kernel_reps or reps
    p0 = cuda_ms(plain, reps)
    k0 = cuda_ms(kernel, kreps)
    k1 = cuda_ms(kernel, kreps)
    p1 = cuda_ms(plain, reps)
    return (k0 + k1) / 2, (p0 + p1) / 2


def bound(nbytes: float, nops: float = 0.0, ops_rate: float = FP32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# B1: the tile scan
# ---------------------------------------------------------------------------


def _round_tf32(x):
    """fp32 values rounded to the nearest TF32 (10 stored mantissa bits), ties to even."""
    b = x.view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def phase_b1(gen):
    b, n = SCAN_SHAPE
    cases = []
    x8 = torch.randint(-128, 128, SCAN_SHAPE, generator=gen, device=DEV).to(torch.int8)
    xi = torch.randint(-3, 4, SCAN_SHAPE, generator=gen, device=DEV).to(torch.float32)
    xr = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    xr64 = xr.double().cpu().numpy()
    ref, scale = ulp.scan_ref(xr64), ulp.scan_scale(xr64)
    limit = B1_F32_ULP
    worst = 0.0
    for s in (16, 128):
        for variant in ("scanu", "scanul1"):
            for name, x in (("int8", x8), ("f32int", xi)):
                got = scan_mm.scan_tiles(x, s=s, variant=variant)
                want = scan_mm.scan_tiles_plain(x, s=s, variant=variant, acc=got.dtype)
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"B1 {name} s={s} {variant}: kernel != plain "
                      f"({int((got != want).sum())} elements)")
                cases.append({"input": name, "s": s, "variant": variant, "exact": True})
            got = scan_mm.scan_tiles(xr, s=s, variant=variant)
            plain = scan_mm.scan_tiles_plain(xr, s=s, variant=variant, acc=torch.float32)
            e_k = ulp.max_ulp(got.cpu().numpy(), ref, scale)
            e_p = ulp.max_ulp(plain.cpu().numpy(), ref, scale)
            worst = max(worst, float((got - plain).abs().max()))
            check(e_k <= limit, f"B1 fp32 s={s} {variant}: kernel {e_k} ulp > {limit}")
            check(e_p <= limit, f"B1 fp32 s={s} {variant}: plain {e_p} ulp > {limit}")
            cases.append({"input": "f32rand", "s": s, "variant": variant,
                          "kernel_max_ulp": e_k, "plain_max_ulp": e_p, "ulp_limit": limit})
    # controls: the plain scan of the same input with its operands rounded as a
    # TF32 or bf16 tile product would round them must fail the limit above
    controls = {}
    for name, xc in (("tf32_operands", _round_tf32(xr)),
                     ("bf16_operands", xr.to(torch.bfloat16).float())):
        out = scan_mm.scan_tiles_plain(xc, s=128, variant="scanul1", acc=torch.float32)
        controls[name] = ulp.max_ulp(out.cpu().numpy(), ref, scale)
        check(controls[name] > limit,
              f"B1 fp32 limit {limit} ulp passes a {name} scan ({controls[name]} ulp)")
    # a ragged row exercises the tail masking of the last tile
    xg = torch.randint(-100, 100, (3, 100003), generator=gen, device=DEV, dtype=torch.int32)
    for s in (8, 128):
        got = scan_mm.scan_tiles(xg, s=s)
        check(torch.equal(got, torch.cumsum(xg, -1, dtype=torch.int32)),
              f"B1 ragged int32 s={s}: kernel != cumsum")
    # the single pass: the look-back's fold is the same chain on every run, and a
    # launch at (4, 2^24) runs one CTA a group, many a row
    for s in (16, 128):
        first = scan_mm.scan_tiles(xr, s=s)
        check(all(torch.equal(scan_mm.scan_tiles(xr, s=s), first) for _ in range(5)),
              f"B1 fp32 s={s}: five repeated calls differ")
    ctas = launched_ctas(lambda ws: scan_mm._scan_tiles_cuda(xr, s=128, variant="scanul1",
                                                            acc=torch.float32, ws=ws),
                         b * scan_mm.group_geometry(128, n)[2])
    check(ctas == b * scan_mm.group_geometry(128, n)[2] and ctas > b,
          f"B1 at {list(SCAN_SHAPE)}: {ctas} CTAs")
    edges = scan_tile_edges(gen)
    sync()
    emit({"phase": "b1", "shape": list(SCAN_SHAPE), "cases": cases,
          "controls_max_ulp": controls, "max_abs_err_f32rand_vs_plain": worst,
          "repeats_bit_equal": 5, "ctas": ctas, "ctas_per_row": ctas // b, **edges})
    return worst


def launched_ctas(call, tiles: int) -> int:
    """The CTAs one launch of B1 or B9 ran: ``call(ws)`` launches with the look-back
    workspace ``ws`` for ``tiles`` tiles, whose last word is the tile counter."""
    ws = lookback.workspace(tiles, DEV)
    call(ws)
    sync()
    return int(ws[-1])


def tile_edge_rows(tile: int):
    return (1, tile - 1, tile, tile + 1, 3 * tile + 17)


def scan_tile_edges(gen) -> dict:
    """One B1 launch per case at and around the edge of its CTA groups (G elements
    of ``group_geometry``: one 128 x 128 tile, 64 tiles of 16 x 16, 256 of 8 x 8),
    both variants, batches of 1 and 64: exact against the plain version and an
    int32 cumsum."""
    cases = 0
    for s in (8, 16, 128):
        group = scan_mm.group_geometry(s, SCAN_SHAPE[1])[1]
        for b in (1, 64):
            for n in tile_edge_rows(group):
                x = torch.randint(-100, 100, (b, n), generator=gen, device=DEV,
                                  dtype=torch.int32)
                for variant in ("scanu", "scanul1"):
                    tag = f"B1 tile edge s={s} b={b} n={n} {variant}"
                    ops.reset_launch_counts()
                    got = scan_mm.scan_tiles(x, s=s, variant=variant)
                    sync()
                    expect_counts(ops.launch_counts(), tag, scan_mm=1)
                    check(torch.equal(got, torch.cumsum(x, -1, dtype=torch.int32)) and
                          torch.equal(got, scan_mm.scan_tiles_plain(x, s=s, variant=variant,
                                                                    acc=torch.int32)),
                          f"{tag}: kernel != cumsum or plain")
                    cases += 1
    return {"tile_edge_cases": cases, "tile_edge_groups": {
        str(s): scan_mm.group_geometry(s, SCAN_SHAPE[1])[1] for s in (8, 16, 128)}}


# ---------------------------------------------------------------------------
# B7: radix passes
# ---------------------------------------------------------------------------


def _enc16_desc(keys16):
    """The sampler's sort keys: bf16 bits, order-encoded, complemented (descending)."""
    u = keys16.view(torch.int16)
    return ~torch.where(u < 0, ~u, u | -(1 << 15))


def _b7_hold(work, perm, shift, bits, tag) -> int:
    """One B7 pass against its plain version."""
    kw, kp = split_mm.radix_pass_multibit(work, perm, shift=shift, pass_bits=bits)
    pw, pp = split_mm.radix_pass_plain(work, perm, shift=shift, pass_bits=bits)
    check(torch.equal(kw, pw) and torch.equal(kp, pp), f"B7 {tag} shift={shift}: != plain")
    return max(int((kw.long() - pw.long()).abs().max()), int((kp - pp).abs().max()))


def radix_tile_edges(gen, with_counts: bool) -> dict:
    """One pass of B7 (``with_counts``: B7h) per case at and around the edge of the
    tile split, each exactly one launch and exact against its plain version (B7h's
    counts also against a bincount): rows of 1, TILE - 1, TILE, TILE + 1 and
    3 TILE + 17 keys with runs of equal keys across every tile edge, batches of 1
    and 64, 1-, 4- and 8-bit digits (the top digit) of 8-, 16- and 32-bit keys."""
    tile = split_mm.RADIX_TILE
    name = "radix_pass_hist" if with_counts else "radix_pass"
    worst, cases = 0, 0
    for word, key_bits in split_mm.KEY_DTYPES.items():
        for b in (1, 64):
            for n in (1, tile - 1, tile, tile + 1, 3 * tile + 17):
                w = torch.randint(-(1 << 31), (1 << 31) - 1, (b, n), generator=gen, device=DEV,
                                  dtype=torch.int64).to(word)
                for edge in range(tile, n, tile):
                    w[:, edge - 5:edge + 5] = w[:, edge - 5:edge - 4]
                perm = torch.randperm(n, generator=gen, device=DEV).to(torch.int32)
                perm = perm.expand(b, n).contiguous()
                for k in (1, 4, 8):
                    tag = f"{word} b={b} n={n} k={k}"
                    ops.reset_launch_counts()
                    hold = _b7h_hold if with_counts else _b7_hold
                    worst = max(worst, hold(w, perm, key_bits - k, k, f"tile edge {tag}"))
                    expect_counts(ops.launch_counts(), f"{name} {tag}", **{name: 1})
                    cases += 1
    return {"tile": tile, "tile_edge_cases": cases, "tile_edge_max_abs_err": worst}


def phase_b7(gen):
    n = 128256
    probs = torch.softmax(torch.randn((VOCAB_ROWS, n), generator=gen, device=DEV) * 2, -1)
    keys16 = probs.to(torch.bfloat16)
    keys32 = torch.randn((VOCAB_ROWS, n), generator=gen, device=DEV)
    keys32[:, 1000:2000] = keys32[:, :1000]                   # duplicate keys: stability
    # each pass of the sampler's 4-pass chain against the plain pass, on the same inputs
    work = _enc16_desc(keys16)
    perm = torch.arange(n, dtype=torch.int32, device=DEV).expand(VOCAB_ROWS, n).contiguous()
    worst = 0
    for shift in range(0, 16, 4):
        kw, kp = split_mm.radix_pass_multibit(work, perm, shift=shift, pass_bits=4)
        pw, pp = split_mm.radix_pass_plain(work, perm, shift=shift, pass_bits=4)
        worst = max(worst, int((kw.int() - pw.int()).abs().max()),
                    int((kp - pp).abs().max()))
        check(torch.equal(kw, pw) and torch.equal(kp, pp), f"B7 bf16 pass shift={shift}")
        work, perm = kw, kp
    results = []
    for name, keys in (("bfloat16", keys16), ("float32", keys32)):
        lib_v, lib_i = torch.sort(keys, dim=-1, descending=True, stable=True)
        for bpp in (1, 2, 4, 8):
            v, i = radix_sort(keys, descending=True, method="kernel", bits_per_pass=bpp)
            pv, pi = radix_sort(keys, descending=True, method="vector", bits_per_pass=bpp)
            check(torch.equal(i, pi) and torch.equal(v, pv),
                  f"B7 {name} bits_per_pass={bpp}: kernel chain != plain chain")
            check(torch.equal(i.long(), lib_i) and torch.equal(v, lib_v),
                  f"B7 {name} bits_per_pass={bpp}: != stable torch.sort")
            results.append({"keys": name, "bits_per_pass": bpp, "exact": True})
    edges = radix_tile_edges(gen, with_counts=False)
    worst = max(worst, edges["tile_edge_max_abs_err"])
    sync()
    emit({"phase": "b7", "shape": [VOCAB_ROWS, n], "cases": results, **edges,
          "max_abs_err_per_pass_vs_plain": worst})
    return worst


# ---------------------------------------------------------------------------
# B8: the top-p tail
# ---------------------------------------------------------------------------


def topp_window(sp, u, p):
    """The fp64 index of the top-p tail, and the least and greatest index the
    kernel may return, for each row of ``sp`` (sorted descending) and ``u``.

    A decision of the tail -- whether a token is cut, whether a CDF value lies
    below ``theta`` -- can go either way only where its fp64 quantity lies within
    ``TOPP_BAND`` of the row's mass of its threshold (``topp_tail.cu``).  So the
    kernel's index lies in ``[lo, hi]``: over every cut that the band allows, the
    indices whose CDF step lies within the band of that cut's ``theta``.  Where
    ``lo == hi`` the row has one right answer.  Returns int64 numpy ``(ref, lo, hi)``.
    """
    sp64 = sp.double().cpu().numpy()
    u64 = u.double().cpu().numpy().reshape(-1)
    rows, n = sp64.shape
    ref, lo, hi = (np.empty(rows, np.int64) for _ in range(3))
    for r in range(rows):
        cum = np.cumsum(sp64[r])                  # nondecreasing: every term is >= 0
        before = cum - sp64[r]
        d = split_mm.TOPP_BAND * cum[-1]

        def kept(q):                               # tokens whose preceding mass is <= q
            return max(int(np.count_nonzero(before <= q)), 1)

        def count(c, t):                           # min(#(cdf < t), n - 1) under cut c
            k = min(int(np.searchsorted(cum, t, "left")), c)
            return min(k + (n - c) * int(cum[c - 1] < t), n - 1)

        ref[r] = count(kept(p), u64[r] * cum[kept(p) - 1])
        js = [count(c, u64[r] * cum[c - 1] + sign * d)
              for c in range(kept(p - d), kept(p + d) + 1) for sign in (-1, 1)]
        lo[r], hi[r] = min(js), max(js)
    return ref, lo, hi


def mid_step_uniforms(sp, p):
    """Per row, the uniform that puts ``theta`` in the middle of the deepest kept
    CDF step at least 8 bands wide, so that the row has one right answer even
    where most of its steps are narrower than the band."""
    sp64 = sp.double().cpu().numpy()
    u = np.empty((sp64.shape[0], 1), np.float32)
    for r, row in enumerate(sp64):
        cum = np.cumsum(row)
        kept = max(int(np.count_nonzero(cum - row <= p)), 1)
        k = min(int(np.count_nonzero(row >= 8 * split_mm.TOPP_BAND * cum[-1])), kept) - 1
        check(k >= 0, "B8: a row without a CDF step wider than the band")
        u[r, 0] = (cum[k] - row[k] / 2) / cum[kept - 1]
    return torch.from_numpy(u).to(DEV)


def phase_b8(gen):
    n, p = 128256, 0.9
    rows = exact = deepest = 0
    worst = widest = 0
    for sigma in (1.0, 2.0, 4.0, 8.0):
        for rep in range(8):
            logits = torch.randn((VOCAB_ROWS, n), generator=gen, device=DEV) * sigma
            sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
            u = torch.rand((VOCAB_ROWS, 1), generator=gen, device=DEV)
            draws = [u]
            if sigma <= 2.0 and rep < 2:           # flat rows, each with one right answer
                draws.append(mid_step_uniforms(sp, p))
            for i, uu in enumerate(draws):
                jk = split_mm.topp_mask_sample_tiles(sp, uu, p=p).long().cpu().numpy()
                jp = split_mm.topp_tail_plain(sp, uu, p=p).long().cpu().numpy()
                jr, lo, hi = topp_window(sp, uu, p)
                check(((lo <= jk) & (jk <= hi)).all(),
                      f"B8 sigma={sigma}: kernel index outside the band's window "
                      f"(kernel {jk.tolist()}, window {lo.tolist()}..{hi.tolist()})")
                one = lo == hi
                check(i == 0 or one.all(), f"B8 sigma={sigma}: a mid-step row is in the band")
                check((jk[one] == jr[one]).all() and (jk[one] == jp[one]).all(),
                      f"B8 sigma={sigma}: kernel != plain or fp64 on a row outside the band")
                worst = max(worst, int(np.abs(jk - jp).max()))
                widest = max(widest, int((hi - lo).max()))
                rows += VOCAB_ROWS
                exact += int(one.sum())
                if i:
                    deepest = max(deepest, int(jr.max()))
    shapes = b8_shapes(gen, p)
    worst = max(worst, max(r["max_index_diff_vs_plain"] for r in shapes))
    sync()
    emit({"phase": "b8", "shape": [VOCAB_ROWS, n], "p": p, "band": split_mm.TOPP_BAND,
          "rows": rows, "rows_with_one_answer": exact, "widest_window": widest,
          "deepest_mid_step_index": deepest, "max_index_diff_vs_plain": worst,
          "shapes": shapes})
    return worst


def b8_shapes(gen, p) -> list:
    """B8 at the rows of ``B8_ROWS``: on and around the slices' 16-byte words, the
    sampler's vocabularies, paligemma's 257216 (one round) and 2^20 (three rounds of
    the cluster's walk).  On every row the index lies inside the band's window and
    equals the plain version and fp64 where the window holds one index; it is the
    index of the kernel's model (``split_mm._topp_tail_cluster``, the same operations
    in the same order) and the same over five more calls, one launch each."""
    out = []
    for n in B8_ROWS:
        logits = torch.randn((VOCAB_ROWS, n), generator=gen, device=DEV) * 2.0
        sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
        draws = (torch.rand((VOCAB_ROWS, 1), generator=gen, device=DEV),
                 mid_step_uniforms(sp, p))
        one_answer = worst = 0
        for i, uu in enumerate(draws):
            tag = f"B8 n={n} {'mid-step' if i else 'random'} uniforms"
            ops.reset_launch_counts()
            got = split_mm.topp_mask_sample_tiles(sp, uu, p=p)
            sync()
            expect_counts(ops.launch_counts(), tag, topp_tail=1)
            jk = got.long().cpu().numpy()
            jp = split_mm.topp_tail_plain(sp, uu, p=p).long().cpu().numpy()
            jr, lo, hi = topp_window(sp, uu, p)
            check(((lo <= jk) & (jk <= hi)).all(), f"{tag}: kernel index outside the band's "
                  f"window (kernel {jk.tolist()}, window {lo.tolist()}..{hi.tolist()})")
            # a mid-step uniform keeps theta off the CDF's edges, but on short rows
            # a token larger than the band may sit at the cut, so not every row
            # has one answer here: the count of those that do is recorded
            one = lo == hi
            check((jk[one] == jr[one]).all() and (jk[one] == jp[one]).all(),
                  f"{tag}: kernel != plain or fp64 on a row outside the band")
            model = split_mm._topp_tail_cluster(sp.cpu(), uu.cpu(), p=p)
            check(torch.equal(got.cpu(), model), f"{tag}: kernel != its model "
                  f"({got.tolist()} against {model.tolist()})")
            check(all(torch.equal(split_mm.topp_mask_sample_tiles(sp, uu, p=p), got)
                      for _ in range(5)), f"{tag}: five repeated calls differ")
            one_answer += int(one.sum())
            worst = max(worst, int(np.abs(jk - jp).max()))
        slice_, rounds, threads, items = split_mm.topp_tail_geometry(n)
        out.append({"n": n, "slice": slice_, "rounds": rounds, "threads": threads,
                    "items": items,
                    "rows": len(draws) * VOCAB_ROWS, "rows_with_one_answer": one_answer,
                    "max_index_diff_vs_plain": worst, "repeats_equal": 5})
    return out


# ---------------------------------------------------------------------------
# B2-B4: the blocked pipeline
# ---------------------------------------------------------------------------


def _ulp_cpu(got, ref, scale):
    return ulp.max_ulp(got.cpu().numpy(), ref, scale)


def phase_b2b4(gen):
    """B2, B3, B2 + B3 in one launch and B4 each against their plain versions on the
    same inputs (the fused sums bit-equal to B2's, its carries to B3's on them), then
    the whole pipeline; ints and integer-valued fp32 exact, random fp32 within
    ``B1_F32_ULP`` of the fp64 scan (block sums and carries at the scan's scale)."""
    b, n = SCAN_SHAPE
    inputs = {
        "int8": torch.randint(-128, 128, SCAN_SHAPE, generator=gen, device=DEV).to(torch.int8),
        "int32": torch.randint(-1000, 1000, SCAN_SHAPE, generator=gen, device=DEV,
                               dtype=torch.int32),
        "f32int": torch.randint(-3, 4, SCAN_SHAPE, generator=gen,
                                device=DEV).to(torch.float32),
        "f32rand": torch.randn(SCAN_SHAPE, generator=gen, device=DEV),
    }
    xr64 = inputs["f32rand"].double()
    ref_np, scale_np = ulp.scan_ref(xr64.cpu().numpy()), ulp.scan_scale(xr64.cpu().numpy())
    limit = B1_F32_ULP
    cases = []
    worst = {"B2": 0.0, "B3": 0.0, "B2B3": 0.0, "B4": 0.0}
    for s in (16, 128):
        for bt in (1, 8):
            m, block_len, nb = scan_pipeline.block_geometry(n, s, bt)
            for name, x in inputs.items():
                blocks = x.reshape(b, nb, m, s)
                acc = accum_dtype_for(x.dtype)
                tag = f"{name} s={s} block_tiles={bt}"
                sums = scan_pipeline.block_partial_sums(blocks)
                sums_p = scan_pipeline.block_partial_sums_plain(blocks, acc)
                carries = scan_pipeline.carry_scan(sums_p)
                carries_p = scan_pipeline.carry_scan_plain(sums_p)
                # B2 + B3 in one launch: B2's bits, and B3's bits on those sums
                fsums, fcar = scan_pipeline.block_sums_carries(blocks)
                check(torch.equal(fsums, sums), f"B2+B3 fused {tag}: sums != B2's")
                check(torch.equal(fcar, scan_pipeline.carry_scan(fsums)),
                      f"B2+B3 fused {tag}: carries != B3's on the same sums")
                case = {"input": name, "s": s, "block_tiles": bt, "nb": nb}
                if name != "f32rand":
                    check(torch.equal(sums, sums_p), f"B2 {tag}: kernel != plain")
                    check(torch.equal(carries, carries_p), f"B3 {tag}: kernel != plain")
                    check(torch.equal(fcar, carries_p), f"B2+B3 fused {tag}: carries != plain")
                else:
                    check(all(all(map(torch.equal, scan_pipeline.block_sums_carries(blocks),
                                      (fsums, fcar))) for _ in range(5)),
                          f"B2+B3 fused {tag}: five fp32 calls not bit-equal")
                    b64 = blocks.double()
                    bref, bscale = b64.sum((-2, -1)), b64.abs().sum((-2, -1))
                    cref = torch.cumsum(bref, -1) - bref
                    cscale = torch.cumsum(bscale, -1) - bscale
                    for key, got, plain, r, sc in (
                            ("B2", sums, sums_p, bref, bscale),
                            ("B3", carries, carries_p, cref, cscale),
                            ("B2B3", fcar, carries_p, cref, cscale)):
                        r, sc = r.cpu().numpy(), sc.cpu().numpy()
                        e_k, e_p = _ulp_cpu(got, r, sc), _ulp_cpu(plain, r, sc)
                        check(e_k <= limit and e_p <= limit,
                              f"{key} {tag}: kernel {e_k} / plain {e_p} ulp > {limit}")
                        worst[key] = max(worst[key], float((got - plain).abs().max()))
                        case[f"{key}_kernel_max_ulp"], case[f"{key}_plain_max_ulp"] = e_k, e_p
                for variant in ("scanu", "scanul1"):
                    got = scan_pipeline.block_scan_carry(blocks, carries_p, variant=variant)
                    plain = scan_pipeline.block_scan_carry_plain(blocks, carries_p,
                                                                 variant=variant, acc=acc)
                    whole = scan(x, method="blocked", tile_s=s, block_tiles=bt,
                                 variant=variant)
                    if name != "f32rand":
                        check(torch.equal(got, plain), f"B4 {tag} {variant}: kernel != plain")
                        check(torch.equal(whole, plain.reshape(b, n)),
                              f"pipeline {tag} {variant}: kernel != plain")
                        continue
                    e_k = _ulp_cpu(got.reshape(b, n), ref_np, scale_np)
                    e_p = _ulp_cpu(plain.reshape(b, n), ref_np, scale_np)
                    e_w = _ulp_cpu(whole, ref_np, scale_np)
                    check(max(e_k, e_p, e_w) <= limit,
                          f"B4 {tag} {variant}: kernel {e_k} / plain {e_p} / pipeline "
                          f"{e_w} ulp > {limit}")
                    worst["B4"] = max(worst["B4"], float((got - plain).abs().max()))
                    case[f"B4_{variant}_kernel_max_ulp"] = e_k
                    case[f"B4_{variant}_plain_max_ulp"] = e_p
                    case[f"pipeline_{variant}_max_ulp"] = e_w
                cases.append(case)
    # a ragged row, and a row that is one block at the default geometry
    rows = []
    for n2 in (RAGGED_N, VOCAB):
        xg = torch.randint(-1000, 1000, (b, n2), generator=gen, device=DEV, dtype=torch.int32)
        xr = torch.randn((b, n2), generator=gen, device=DEV)
        x8 = torch.randint(-128, 128, (b, n2), generator=gen, device=DEV).to(torch.int8)
        r64 = xr.double().cpu().numpy()
        ref2, scale2 = ulp.scan_ref(r64), ulp.scan_scale(r64)
        for s, bt in ((16, 1), (128, 8)):
            nb = scan_pipeline.block_geometry(n2, s, bt)[2]
            for variant in ("scanu", "scanul1"):
                ops.reset_launch_counts()
                got = scan_pipeline.blocked_scan(xg, s=s, block_tiles=bt, variant=variant)
                sync()
                two = 1 if nb > 1 else 0
                expect_counts(ops.launch_counts(), f"blocked_scan n={n2} s={s} nb={nb}",
                              block_sums=two, block_scan=1)
                plain = scan_pipeline.blocked_scan_plain(xg, s=s, block_tiles=bt,
                                                         variant=variant, acc=torch.int32)
                check(torch.equal(got, plain) and
                      torch.equal(got, torch.cumsum(xg, -1, dtype=torch.int32)),
                      f"pipeline int32 n={n2} s={s} {variant}: kernel != plain or cumsum")
                e = _ulp_cpu(scan_pipeline.blocked_scan(xr, s=s, block_tiles=bt,
                                                        variant=variant), ref2, scale2)
                check(e <= limit, f"pipeline fp32 n={n2} s={s} {variant}: {e} ulp > {limit}")
                rows.append({"n": n2, "s": s, "block_tiles": bt, "nb": nb,
                             "variant": variant, "f32rand_max_ulp": e})
            # int8 rows (off 16-byte alignment at RAGGED_N): the fused launch on the raw
            # rows against the plain versions on the zero-padded block view, and the scan
            m, block_len, _ = scan_pipeline.block_geometry(n2, s, bt)
            xk, code = scan_mm.kernel_operand(x8, torch.int32, op="phase_b2b4")
            fsums, fcar = scan_pipeline._block_sums_carries_cuda(xk, code, torch.int32, nb,
                                                                block_len)
            pad = torch.nn.functional.pad(x8.to(torch.int32), (0, nb * block_len - n2))
            ps, pc = scan_pipeline.block_sums_carries_plain(pad.reshape(b, nb, m, s),
                                                            torch.int32)
            check(torch.equal(fsums, ps) and torch.equal(fcar, pc),
                  f"B2+B3 fused int8 n={n2} s={s}: != plain")
            check(torch.equal(scan_pipeline.blocked_scan(x8, s=s, block_tiles=bt),
                              torch.cumsum(x8, -1, dtype=torch.int32)),
                  f"pipeline int8 n={n2} s={s}: != cumsum")
    sync()
    emit({"phase": "b2b4", "shape": list(SCAN_SHAPE), "cases": cases, "rows": rows,
          "ulp_limit": limit, "max_abs_err_f32rand_vs_plain": worst})
    return worst


# ---------------------------------------------------------------------------
# B5: SplitInd
# ---------------------------------------------------------------------------


_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _b5_hold(x, f, tag) -> int:
    """One B5 launch, exact against its plain version and a stable argsort of the
    flags (any nonzero flag is true), ``n_true`` equal to the flag count.  Returns
    the largest absolute difference from the plain version: ``z`` compared as raw
    integer words of its element size, ``ind`` and ``n_true`` as integers."""
    ops.reset_launch_counts()
    z, ind, cnt = split_mm.split_tiles(x, f)
    sync()
    expect_counts(ops.launch_counts(), tag, split=1)
    pz, pind, pcnt = split_mm.split_plain(x, f != 0)
    word = _WORD[z.element_size()]
    worst = max(int((z.view(word).long() - pz.view(word).long()).abs().max()),
                int((ind.long() - pind.long()).abs().max()),
                int((cnt.long() - pcnt.long()).abs().max()))
    check(torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt),
          f"{tag}: kernel != plain")
    order = torch.argsort((f == 0).to(torch.uint8), dim=-1, stable=True)
    check(torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order)),
          f"{tag}: indices != stable argsort")
    check(torch.equal(cnt.long(), (f != 0).sum(-1)), f"{tag}: n_true != flag count")
    return worst


def b5_tile_edges(gen) -> dict:
    """One B5 launch per case at and around the edge of its tiles (rows of 1,
    TILE - 1, TILE, TILE + 1 and 3 TILE + 17, TILE = 4096), batches of 1 and 64,
    every word size, flags of 1, 2 and -1 with runs across every tile edge (an
    all-true and an all-false row in a batch), then payload and flags that start
    off a 16-byte boundary: exact, one launch each."""
    cases, worst = 0, 0
    tile = split_mm.RADIX_TILE
    for b in (1, 64):
        for n in tile_edge_rows(tile):
            f = (torch.rand((b, n), generator=gen, device=DEV) < 0.5).to(torch.int8)
            f *= torch.tensor([1, 2, -1], dtype=torch.int8, device=DEV)[
                torch.randint(0, 3, (b, n), generator=gen, device=DEV)]
            for edge in range(tile, n, tile):
                f[:, edge - 5:edge + 5] = f[:, edge - 5:edge - 4]
            if b > 1:
                f[1], f[2] = 1, 0
            for word, dt in _WORD.items():
                x = torch.randint(-(1 << 7), 1 << 7, (b, n), generator=gen,
                                  device=DEV).to(dt)
                worst = max(worst, _b5_hold(x, f, f"B5 tile edge b={b} n={n} {word}-byte"))
                cases += 1
    b, n = 3, 2 * tile + 5
    for word, dt in _WORD.items():
        base = torch.randint(-100, 100, (b * n + 1,), generator=gen, device=DEV).to(dt)
        fb = torch.rand((b * n + 3,), generator=gen, device=DEV) < 0.3
        x, f = base[1:].view(b, n), fb[3:].view(b, n)
        check(x.data_ptr() % 16 != 0 and f.data_ptr() % 16 != 0, "B5 unaligned: aligned")
        worst = max(worst, _b5_hold(x, f, f"B5 unaligned {word}-byte"))
        cases += 1
    return {"tile_edge_cases": cases, "tile": tile, "tile_edge_max_abs_err": worst}


def phase_b5(gen):
    """SplitInd against its plain version and a stable argsort of the flags, exact,
    one launch a call, at (4, 2^24) and (4, 128256) and at its tile edges.

    Returns the largest absolute difference between kernel and plain output
    over every case: ``z`` compared as raw integer words of its element size,
    ``ind`` and ``n_true`` as integers.
    """
    cases = []
    worst = 0
    for n in (SCAN_SHAPE[1], VOCAB):
        shape = (SCAN_SHAPE[0], n)
        f = torch.rand(shape, generator=gen, device=DEV) < 0.5
        f[1] = True                                            # all true
        f[2] = False                                           # all false
        for dt in (torch.float32, torch.bfloat16, torch.int64):
            if dt == torch.int64:
                x = torch.randint(-(1 << 40), 1 << 40, shape, generator=gen, device=DEV)
            else:
                x = torch.randn(shape, generator=gen, device=DEV).to(dt)
            worst = max(worst, _b5_hold(x, f, f"B5 n={n} {dt}"))
            cases.append({"n": n, "payload": str(dt).rsplit(".", 1)[-1], "exact": True,
                          "n_true": f.sum(-1).tolist()})
    edges = b5_tile_edges(gen)
    worst = max(worst, edges["tile_edge_max_abs_err"])
    sync()
    emit({"phase": "b5", "cases": cases, **edges, "max_abs_err_vs_plain": worst})
    return worst


# ---------------------------------------------------------------------------
# B9-B12: the segmented scans
# ---------------------------------------------------------------------------


def seg_offsets(rng, n: int) -> torch.Tensor:
    """CSR offsets of a packed row of ``n``: segment lengths log-uniform in
    ``[1, SEG_MAX_LEN]``, every seventh segment empty, the last one cut at ``n``."""
    lens, total = [], 0
    while total < n:
        if len(lens) % 7 == 3:
            lens.append(0)
        ln = min(int(np.exp(rng.uniform(0.0, np.log(SEG_MAX_LEN)))), n - total)
        lens.append(ln)
        total += ln
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32,
                        device=DEV)


def seg_ref64(x, f):
    """The fp64 per-segment inclusive scan of ``x`` under the nonzero ``f`` (broadcast
    to ``x``), and its scale, the running ``Σ|x|`` since the segment start: a
    log-step doubling scan on the card, so no partial sum of another segment is
    ever subtracted."""
    h = (f != 0).expand(x.shape).clone()
    v, a = x.double(), x.double().abs()
    n, d = x.shape[-1], 1
    while d < n:
        ov, oa, oh = torch.zeros_like(v), torch.zeros_like(a), torch.zeros_like(h)
        ov[..., d:], oa[..., d:], oh[..., d:] = v[..., :-d], a[..., :-d], h[..., :-d]
        v = torch.where(h, v, ov + v)
        a = torch.where(h, a, oa + a)
        h |= oh
        d *= 2
    return v, a


def ulp_dev(got, ref, scale):
    """``analysis/ulp.py``'s ulp error of each element, computed on the card:
    ``|got - ref|`` in fp32 spacings at ``scale``."""
    sc = scale.float().clamp(min=float(np.finfo(np.float32).tiny))
    spacing = (torch.nextafter(sc, torch.full_like(sc, float("inf"))) - sc).double()
    return (got.double() - ref).abs() / spacing


def max_ulp_dev(got, ref, scale) -> float:
    """The largest of :func:`ulp_dev`."""
    return float(ulp_dev(got, ref, scale).max())


def _seg_inputs(gen, shape):
    return {
        "int8": torch.randint(-128, 128, shape, generator=gen, device=DEV).to(torch.int8),
        "f32int": torch.randint(-3, 4, shape, generator=gen, device=DEV).to(torch.float32),
        "f32rand": torch.randn(shape, generator=gen, device=DEV),
    }


def phase_seg(gen):
    """B9, B10, B11 and B12 each against its plain version on the same inputs, then
    the segmented scans whole.  Ints and integer-valued fp32 are exact against the
    plain version and an exact reference; random fp32 from a kernel stays within
    ``B1_F32_ULP`` of the fp64 per-segment scan at the per-segment scale.  Returns
    each kernel's largest absolute difference from its plain version."""
    rng = np.random.default_rng(SEG_SEED)
    b, n = SCAN_SHAPE
    offs = [seg_offsets(rng, n) for _ in range(b)]
    flags = torch.stack([boundary_flags(o, n) for o in offs])           # (b, n) int8
    inputs = _seg_inputs(gen, SCAN_SHAPE)
    limit = B1_F32_ULP
    worst = {"B9": 0.0, "B10": 0.0, "B11": 0.0, "B12": 0.0}
    cases = []

    def hold(key, tag, got, plain, ref=None, scale=None, exact=True):
        """Exact (and equal to ``ref``) for ints; for random fp32 the kernel within
        the ulp limit of ``ref``.  Records the kernel's distance from its plain version."""
        worst[key] = max(worst[key], float((got.double() - plain.double()).abs().max()))
        if exact:
            check(got.dtype == plain.dtype and torch.equal(got, plain),
                  f"{key} {tag}: kernel != plain ({int((got != plain).sum())} elements)")
            if ref is not None:
                check(torch.equal(got.double(), ref), f"{key} {tag}: != exact reference")
            return None
        e = max_ulp_dev(got, ref, scale)
        check(e <= limit, f"{key} {tag}: kernel {e} ulp > {limit}")
        return e

    refs = {name: seg_ref64(x, flags) for name, x in inputs.items()}
    for name, x in inputs.items():
        acc, exact = accum_dtype_for(x.dtype), name != "f32rand"
        ref, scale = refs[name]
        got = segscan_mm.seg_scan_tiles(x, flags)
        plain = segscan_mm.seg_scan_tiles_plain(x, flags != 0, s=128, acc=acc)
        case = {"input": name, "B9_max_ulp": hold("B9", name, got, plain, ref, scale, exact),
                "B9_plain_max_ulp": None if exact else max_ulp_dev(plain, ref, scale)}
        for s, bt in ((16, 8), (128, 8)):
            m, block_len, nb = scan_pipeline.block_geometry(n, s, bt)
            blocks, fblocks = x.reshape(b, nb, m, s), flags.reshape(b, nb, m, s)
            tag = f"{name} s={s} block_tiles={bt} nb={nb}"
            ts, hb = segscan_mm.seg_block_summaries(blocks, fblocks)
            pts, phb = segscan_mm.seg_block_summaries_plain(blocks, fblocks, acc)
            check(torch.equal(hb, phb), f"B10 {tag}: has-boundary != plain")
            r_ts, s_ts = segscan_mm.seg_block_summaries_plain(blocks.double(), fblocks,
                                                              torch.float64)
            a_ts, _ = segscan_mm.seg_block_summaries_plain(blocks.double().abs(), fblocks,
                                                           torch.float64)
            case[f"B10_s{s}_max_ulp"] = hold("B10", tag, ts, pts, r_ts, a_ts, exact)
            carries = segscan_mm.seg_carry_scan(pts, phb)
            pcarries = segscan_mm.seg_carry_scan_plain(pts, phb)
            r_c = segscan_mm.seg_carry_scan_plain(pts.double(), phb)
            a_c = segscan_mm.seg_carry_scan_plain(pts.double().abs(), phb)
            case[f"B11_s{s}_max_ulp"] = hold("B11", tag, carries, pcarries, r_c, a_c, exact)
            got = segscan_mm.seg_block_scan_carry(blocks, fblocks, pcarries)
            plain = segscan_mm.seg_block_scan_carry_plain(blocks, fblocks, pcarries, acc)
            case[f"B12_s{s}_max_ulp"] = hold("B12", tag, got.reshape(b, n),
                                             plain.reshape(b, n), ref, scale, exact)
            whole = segscan_mm.seg_blocked_scan(x, flags, s=s, block_tiles=bt)
            if exact:
                check(torch.equal(whole.double(), ref), f"pipeline {tag}: != exact reference")
            else:
                e = max_ulp_dev(whole, ref, scale)
                check(e <= limit, f"pipeline {tag}: {e} ulp > {limit}")
                case[f"pipeline_s{s}_max_ulp"] = e
                case[f"B12_s{s}_plain_max_ulp"] = max_ulp_dev(plain.reshape(b, n), ref, scale)
        cases.append(case)
    del refs
    # the operator over offsets shared by every row, on a ragged row, a one-block row
    # and the sampler's one-hot rows
    rows = []
    onehot = (torch.randint(0, 16, (4 * VOCAB,), generator=gen, device=DEV)
              == torch.arange(16, device=DEV)[:, None]).to(torch.int8)
    for name, x, off in (
            ("ragged int32", torch.randint(-1000, 1000, (b, RAGGED_N), generator=gen,
                                            device=DEV, dtype=torch.int32),
             seg_offsets(rng, RAGGED_N)),
            ("one-block f32rand", torch.randn((b, VOCAB), generator=gen, device=DEV),
             seg_offsets(rng, VOCAB)),
            ("sampler one-hot int8", onehot,
             torch.arange(5, device=DEV, dtype=torch.int32) * VOCAB)):
        nn = x.shape[-1]
        f = boundary_flags(off, nn)
        ref, scale = seg_ref64(x, f)
        exact = x.dtype != torch.float32
        nb = scan_pipeline.block_geometry(nn, 128, 8)[2]
        row = {"case": name, "shape": list(x.shape), "nb": nb}
        for method, want in (("kernel", {"seg_scan": 1}),
                             ("blocked", {"seg_block_scan": 1, **(
                                 {"seg_summaries": 1, "seg_carry": 1} if nb > 1 else {})})):
            ops.reset_launch_counts()
            got = segment_scan(x, off, method=method)
            sync()
            expect_counts(ops.launch_counts(), f"segment_scan {name} {method}", **want)
            if exact:
                check(torch.equal(got.double(), ref), f"segment_scan {name} {method}: "
                      "!= exact reference")
            else:
                e = row[f"{method}_max_ulp"] = max_ulp_dev(got, ref, scale)
                check(e <= limit, f"segment_scan {name} {method}: {e} ulp > {limit}")
        xb = x.reshape(-1, nn)
        plain = segscan_mm.seg_scan_tiles_plain(xb, f.expand(xb.shape) != 0, s=128,
                                                acc=accum_dtype_for(x.dtype))
        row["B9_max_ulp"] = hold("B9", name, segscan_mm.seg_scan_tiles(x, f),
                                 plain.reshape(x.shape), ref, scale, exact)
        rows.append(row)
    # the single pass: five repeated fp32 calls, the CTAs a launch ran, the
    # sampler's single scan and the tile edges
    xr = inputs["f32rand"]
    first = segscan_mm.seg_scan_tiles(xr, flags)
    check(all(torch.equal(segscan_mm.seg_scan_tiles(xr, flags), first) for _ in range(5)),
          "B9 fp32: five repeated calls differ")
    tiles = b * -(-n // segscan_mm.seg_scan_tile(n))
    ctas = launched_ctas(lambda ws: segscan_mm._seg_scan_cuda(
        xr, 0, flags, n, torch.float32, ws=ws), tiles)
    check(ctas == tiles and ctas > b, f"B9 at {list(SCAN_SHAPE)}: {ctas} CTAs")
    x1, f1 = sampler_scan_inputs(gen)
    ops.reset_launch_counts()
    got = segscan_mm.seg_scan_tiles(x1, f1)
    sync()
    expect_counts(ops.launch_counts(), "B9 sampler scan", seg_scan=1)
    ref1, _ = seg_ref64(x1, f1)
    check(torch.equal(got.double(), ref1), "B9 sampler scan (1, 513024): != exact reference")
    hold("B9", "sampler scan", got, segscan_mm.seg_scan_tiles_plain(
        x1, f1.expand(x1.shape) != 0, s=128, acc=torch.int32), ref1)
    edges = seg_tile_edges(gen, hold)
    # B10's walk: five repeated fp32 calls at the pipeline's geometry, the bits
    # of the fold in the kernel's order, then its run and block edges
    m, _, nb = scan_pipeline.block_geometry(n, 128, 8)
    blocks, fblocks = xr.reshape(b, nb, m, 128), flags.reshape(b, nb, m, 128)
    first = segscan_mm.seg_block_summaries(blocks, fblocks)
    check(all(all(torch.equal(u, v) for u, v in zip(
        segscan_mm.seg_block_summaries(blocks, fblocks), first)) for _ in range(5)),
        "B10 fp32: five repeated calls differ")
    fold = segscan_mm.seg_block_summaries_plain(blocks, fblocks, torch.float32, fold=True)
    check(torch.equal(first[0], fold[0]) and torch.equal(first[1], fold[1]),
          "B10 fp32: not the bits of the fold in the kernel's order")
    b10_edges = seg_summaries_edges(gen, hold)
    b11 = seg_carry_pass(gen, hold)
    sync()
    emit({"phase": "seg", "shape": list(SCAN_SHAPE), "segments_per_row": [
        int(o.numel() - 1) for o in offs], "ulp_limit": limit, "cases": cases, "rows": rows,
        "repeats_bit_equal": 5, "ctas": ctas, "ctas_per_row": ctas // b,
        "sampler_scan": {"shape": list(x1.shape), "tiles": -(-x1.shape[-1] // segscan_mm.
                                                              seg_scan_tile(x1.shape[-1]))},
        **edges, "B10": {"repeats_bit_equal": 5, "fold_bit_equal": True, **b10_edges},
        "B11": b11, "max_abs_err_vs_plain": worst})
    return worst


def seg_carry_pass(gen, hold) -> list:
    """B11, B9's single pass made exclusive, at one tile (the pipeline's nb = 128 and
    8192: one CTA a row, no workspace) and over many (8193 to 2^20 summaries a row:
    the look-back, one CTA a tile, counted), on int32 and fp32 summaries with
    has-flag words set at random (one row none, one all, one 7s): int32 exact
    against the exclusive fp64 scan (and the plain version where its masked
    contraction fits), fp32 within ``B1_F32_ULP`` of it at the per-segment scale,
    five repeated fp32 calls bit-equal, one launch a call."""
    out = []
    for nb in B11_ROWS:
        b = 4
        h = (torch.rand((b, nb), generator=gen, device=DEV) < 1e-3).to(torch.int32)
        h[1], h[2] = 0, 1
        h[3] *= 7
        tiles = -(-nb // segscan_mm.seg_scan_tile(nb))
        row = {"nb": nb, "tiles": tiles}
        for name, ts in (("int32", torch.randint(-1000, 1000, (b, nb), generator=gen,
                                                 device=DEV, dtype=torch.int32)),
                         ("f32rand", torch.randn((b, nb), generator=gen, device=DEV))):
            tag = f"B11 nb={nb} {name}"
            ops.reset_launch_counts()
            got = segscan_mm.seg_carry_scan(ts, h)
            sync()
            expect_counts(ops.launch_counts(), tag, seg_carry=1)
            inc, inc_scale = seg_ref64(ts, h)
            ref = torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], -1)
            scale = torch.cat([torch.zeros_like(inc[:, :1]), inc_scale[:, :-1]], -1)
            if name == "int32":
                if nb <= 8192:
                    hold("B11", tag, got, segscan_mm.seg_carry_scan_plain(ts, h), ref)
                else:
                    check(torch.equal(got.double(), ref), f"{tag}: != exact reference")
            else:
                e = row["f32_max_ulp"] = max_ulp_dev(got, ref, scale)
                check(e <= B1_F32_ULP, f"{tag}: {e} ulp > {B1_F32_ULP}")
                check(all(torch.equal(segscan_mm.seg_carry_scan(ts, h), got)
                          for _ in range(5)), f"{tag}: five repeated calls differ")
        if tiles > 1:
            row["ctas"] = launched_ctas(lambda ws: segscan_mm._seg_carry_cuda(ts, h, ws=ws),
                                        b * tiles)
            check(row["ctas"] == b * tiles, f"B11 nb={nb}: {row['ctas']} CTAs")
        out.append(row)
    return out


def sampler_scan_inputs(gen):
    """One segmented scan of the ``topp_segmented`` sampler: a (1, 4 x 128256) int8
    one-hot row over one row of flags at each vocabulary row's start."""
    x = (torch.randint(0, 16, (1, 4 * VOCAB), generator=gen, device=DEV) == 3).to(torch.int8)
    f = torch.zeros(4 * VOCAB, dtype=torch.int8, device=DEV)
    f[::VOCAB] = 1
    return x, f


def seg_tile_edges(gen, hold) -> dict:
    """One B9 launch per case at and around the edge of its tiles (``seg_scan_tile``:
    8192 elements for these rows), batches of 1 and 64, int32 values under flags
    that start segments spanning several tiles, on each tile's first element, nowhere,
    everywhere, at random, and in one row shared by the rows: exact against the plain
    version and the fp64 reference."""
    cases = 0
    tile = segscan_mm.seg_scan_tile(1 << 20)
    for b in (1, 64):
        for n in tile_edge_rows(tile):
            x = torch.randint(-1000, 1000, (b, n), generator=gen, device=DEV,
                              dtype=torch.int32)
            pos = torch.arange(n, device=DEV)
            layouts = {"spanning": (pos % 20000 == 0).expand(b, n),
                       "tile_first": (pos % tile == 0).expand(b, n),
                       "none": torch.zeros((b, n), dtype=torch.bool, device=DEV),
                       "all": torch.ones((b, n), dtype=torch.bool, device=DEV),
                       "random": torch.rand((b, n), generator=gen, device=DEV) < 1e-3,
                       "shared": torch.rand((n,), generator=gen, device=DEV) < 1e-3}
            for name, f in layouts.items():
                f = f.to(torch.int8)
                tag = f"B9 tile edge b={b} n={n} {name}"
                ops.reset_launch_counts()
                got = segscan_mm.seg_scan_tiles(x, f)
                sync()
                expect_counts(ops.launch_counts(), tag, seg_scan=1)
                ref, _ = seg_ref64(x, f)
                hold("B9", tag, got, segscan_mm.seg_scan_tiles_plain(
                    x, f.expand(x.shape) != 0, s=128, acc=torch.int32), ref)
                cases += 1
    return {"tile_edge_cases": cases, "tile": tile}


def seg_summaries_edges(gen, hold) -> dict:
    """One B10 launch per case on raw ``(b, n)`` rows cut into blocks of 64 and 16384
    elements (ragged last blocks; rows of 4095 and 4097 start off 16-byte
    boundaries), batches of 1 and 64, flags per row and one row shared, on each
    run's first or last element, nowhere, everywhere, on each block's last element
    and at random (values 1 to 3), int32 and random fp32 values: has-boundary equal
    to the plain version's, the sums bit-equal to the fold in the kernel's order,
    and exact (int32) or within the ulp limit of the fp64 trailing sum (fp32)."""
    cases = 0
    run = segscan_mm.SEG_SUMMARIES_RUN
    for b in (1, 64):
        for n in tile_edge_rows(split_mm.RADIX_TILE):
            pos = torch.arange(n, device=DEV).expand(b, n)
            for block_len in (64, 16384):
                nb = -(-n // block_len)
                pad = nb * block_len - n
                layouts = {
                    "run_first": pos % run == 0, "run_last": pos % run == run - 1,
                    "none": torch.zeros((b, n), dtype=torch.bool, device=DEV),
                    "all": torch.ones((b, n), dtype=torch.bool, device=DEV),
                    "block_last": (pos % block_len == block_len - 1) | (pos == n - 1),
                    "random": (torch.rand((b, n), generator=gen, device=DEV) < 1e-3)
                    * torch.randint(1, 4, (b, n), generator=gen, device=DEV)}
                for name, lay in layouts.items():
                    for shared in (False, True):
                        f = (lay[0] if shared else lay).to(torch.int8).contiguous()
                        fblocks = torch.nn.functional.pad((f != 0).expand(b, n), (0, pad))
                        fblocks = fblocks.reshape(b, nb, 1, block_len)
                        for kind in ("int32", "f32rand"):
                            if kind == "int32":
                                x = torch.randint(-1000, 1000, (b, n), generator=gen,
                                                  device=DEV, dtype=torch.int32)
                            else:
                                x = torch.randn((b, n), generator=gen, device=DEV)
                            acc = x.dtype
                            tag = (f"B10 edge b={b} n={n} block={block_len} {name} "
                                   f"{'shared' if shared else 'per row'} {kind}")
                            fk, fstride = segscan_mm._flag_rows(f, x.shape)
                            ops.reset_launch_counts()
                            ts, h = segscan_mm._seg_summaries_cuda(
                                x, 0 if kind == "f32rand" else 6, fk, fstride, acc, nb,
                                block_len)
                            sync()
                            expect_counts(ops.launch_counts(), tag, seg_summaries=1)
                            blocks = torch.nn.functional.pad(x, (0, pad)).reshape(
                                b, nb, 1, block_len)
                            fts, fh = segscan_mm.seg_block_summaries_plain(
                                blocks, fblocks, acc, fold=True)
                            pts, ph = segscan_mm.seg_block_summaries_plain(blocks, fblocks, acc)
                            check(torch.equal(h, ph) and torch.equal(h, fh),
                                  f"{tag}: has-boundary != plain")
                            check(torch.equal(ts, fts),
                                  f"{tag}: not the bits of the fold in the kernel's order")
                            r_ts, _ = segscan_mm.seg_block_summaries_plain(
                                blocks.double(), fblocks, torch.float64)
                            a_ts, _ = segscan_mm.seg_block_summaries_plain(
                                blocks.double().abs(), fblocks, torch.float64)
                            hold("B10", tag, ts, pts, r_ts, a_ts, exact=kind == "int32")
                            cases += 1
    return {"edge_cases": cases, "block_lens": [64, 16384]}


# ---------------------------------------------------------------------------
# B13-B16: the linear recurrences
# ---------------------------------------------------------------------------


def lin_ref64(a, b):
    """The recurrence ``y_t = a_t y_{t-1} + b_t`` of the last axis in fp64, by log-step
    doubling of the affine pairs on the card.  Its rounding lies ~2^-29 below fp32's,
    so it stands for the sequential fp64 recurrence, which a host loop could not run
    at (4, 2^24)."""
    av, bv = a.double(), b.double()
    d = 1
    while d < a.shape[-1]:
        bl = torch.nn.functional.pad(bv[..., :-d], (d, 0))
        al = torch.nn.functional.pad(av[..., :-d], (d, 0), value=1.0)
        bv = av * bl + bv
        av = av * al
        d *= 2
    return bv


def lin_inputs(gen, shape):
    """The phase's three kinds of rows: random (a in [0.9, 1) with one exact zero per
    4096, b ~ N(0, 1)), integer-valued (a in {-1, 0, 1}, b in [-3, 3]) and a = 1 with
    integer b (the prefix sum)."""
    n = shape[-1]
    a = 0.9 + 0.1 * torch.rand(shape, generator=gen, device=DEV)
    a = torch.where(a >= 1.0, 0.9, a)
    zeros = torch.arange(0, n, 4096, device=DEV)
    zeros = zeros + torch.randint(0, 4096, zeros.shape, generator=gen, device=DEV)
    a[..., zeros[zeros < n]] = 0.0
    bi = torch.randint(-3, 4, shape, generator=gen, device=DEV).float()
    return {
        "random": (a, torch.randn(shape, generator=gen, device=DEV)),
        "int": (torch.randint(-1, 2, shape, generator=gen, device=DEV).float(), bi),
        "ones": (torch.ones(shape, device=DEV), bi),
    }


def block_views(a, b, s, bt):
    """The identity-padded ``(rows, nb, m, s)`` views of ``(rows, n)`` pairs, and nb."""
    rows, n = a.shape
    m, block_len, nb = scan_pipeline.block_geometry(n, s, bt)
    pad = nb * block_len - n
    ab = torch.nn.functional.pad(a, (0, pad), value=1.0).reshape(rows, nb, m, s)
    bb = torch.nn.functional.pad(b, (0, pad)).reshape(rows, nb, m, s)
    return ab, bb, nb, block_len


def phase_linrec(gen):
    """B13, B14, B15, B14 + B15 in one launch and B16 each against its plain version on
    the same inputs (the fused summaries bit-equal to B14's, its carries to B15's on
    them, also at one tile a block, and five fp32 calls bit-equal), then the pipeline
    whole.  Integer-valued rows are exact against the plain version and the fp64
    recurrence; random fp32 from a kernel stays within ``B1_F32_ULP`` of the fp64
    recurrence, the ulp taken at the recurrence run on ``|a|, |b|``.  Returns each
    kernel's largest absolute difference from its plain version."""
    rows, n = SCAN_SHAPE
    limit = B1_F32_ULP
    worst = {"B13": 0.0, "B14": 0.0, "B15": 0.0, "B14B15": 0.0, "B16": 0.0, "pipeline": 0.0}
    cases = []

    def hold(key, tag, got, plain, ref, scale, exact):
        """Exact (and equal to ``ref``) for integer values; else the kernel within the
        ulp limit of ``ref``.  Records the distance from the plain version, and returns
        the kernel's and the plain version's ulp readings."""
        if plain is not None and key in worst:
            worst[key] = max(worst[key], float((got.double() - plain.double()).abs().max()))
        if exact:
            if plain is not None:
                check(torch.equal(got, plain), f"{key} {tag}: kernel != plain "
                      f"({int((got != plain).sum())} elements)")
            check(torch.equal(got.double(), ref), f"{key} {tag}: != the fp64 recurrence")
            return None, None
        e = max_ulp_dev(got, ref, scale)
        check(e <= limit, f"{key} {tag}: kernel {e} ulp > {limit}")
        return e, (None if plain is None else max_ulp_dev(plain, ref, scale))

    inputs = lin_inputs(gen, SCAN_SHAPE)
    s, bt = 128, 8
    for kind, (a, b) in inputs.items():
        exact = kind != "random"
        ref = lin_ref64(a, b)
        scale = lin_ref64(a.abs(), b.abs())
        case = {"input": kind}
        got = linrec_mm.linrec_scan_tiles(a, b, s=s)
        plain = linrec_mm.linrec_scan_tiles_plain(a, b, s=s, acc=torch.float32)
        case["B13_max_ulp"], case["B13_plain_max_ulp"] = hold("B13", kind, got, plain, ref,
                                                              scale, exact)
        if kind == "ones":
            check(torch.equal(got, scan_mm.scan_tiles(b, s=s)), "B13 with a = 1 != B1")
        del got, plain
        ab, bb, nb, block_len = block_views(a, b, s, bt)
        prods, lasts = linrec_mm.linrec_block_summaries(ab, bb)
        pp, pl = linrec_mm.linrec_block_summaries_plain(ab, bb, torch.float32)
        # the summaries and the states entering the blocks in fp64, and their scales
        rp, rl = linrec_mm.linrec_block_summaries_plain(ab.double(), bb.double(),
                                                        torch.float64)
        _, sl = linrec_mm.linrec_block_summaries_plain(ab.double().abs(), bb.double().abs(),
                                                       torch.float64)
        rc = torch.nn.functional.pad(ref[:, block_len - 1::block_len], (1, 0))[:, :nb]
        sc = torch.nn.functional.pad(scale[:, block_len - 1::block_len], (1, 0))[:, :nb]
        case["B14_prods_max_ulp"] = hold("B14", kind, prods, pp, rp, rp.abs(), exact)[0]
        case["B14_lasts_max_ulp"], case["B14_plain_max_ulp"] = hold("B14", kind, lasts, pl,
                                                                     rl, sl, exact)
        carries = linrec_mm.linrec_carry_scan(prods, lasts)
        pc = linrec_mm.linrec_carry_scan_plain(prods, lasts)
        case["B15_max_ulp"], case["B15_plain_max_ulp"] = hold("B15", kind, carries, pc, rc,
                                                              sc, exact)
        # B14 + B15 in one launch: B14's bits, and B15's bits on those summaries
        fp, fl, fc = linrec_mm.linrec_summaries_carries(ab, bb)
        check(torch.equal(fp, prods) and torch.equal(fl, lasts),
              f"B14+B15 fused {kind}: summaries != B14's")
        check(torch.equal(fc, carries), f"B14+B15 fused {kind}: carries != B15's on the "
              f"same summaries")
        case["B14B15_max_ulp"] = hold("B14B15", kind, fc, pc, rc, sc, exact)[0]
        del fp, fl, fc
        # B16 seeded with the exact states entering the blocks, rounded to fp32
        cin = rc.float()
        out = linrec_mm.linrec_block_scan_carry(ab, bb, cin).reshape(rows, -1)[:, :n]
        po = linrec_mm.linrec_block_scan_carry_plain(ab, bb, cin, torch.float32)
        case["B16_max_ulp"], case["B16_plain_max_ulp"] = hold(
            "B16", kind, out, po.reshape(rows, -1)[:, :n], ref, scale, exact)
        del ab, bb, out, po
        whole = linrec_mm.linrec_blocked_scan(a, b, s=s, block_tiles=bt)
        wplain = linrec_mm.linrec_blocked_scan_plain(a, b, s=s, block_tiles=bt,
                                                     acc=torch.float32)
        case["pipeline_max_ulp"], case["pipeline_plain_max_ulp"] = hold(
            "pipeline", kind, whole, wplain, ref, scale, exact)
        case["nb"] = nb
        cases.append(case)
        del whole, wplain
    # the fused launch on the random rows at the default geometry and at one tile a
    # block (65536 blocks a row: CTAs of 32 threads play B15's 1024): B14's and B15's
    # bits, and five more calls bit-equal to the first
    a, b = inputs["random"]
    fused = {}
    for s1, bt1 in ((s, bt), (16, 1)):
        ab, bb, nb1, _ = block_views(a, b, s1, bt1)
        first = linrec_mm.linrec_summaries_carries(ab, bb)
        p1, l1 = linrec_mm.linrec_block_summaries(ab, bb)
        check(torch.equal(first[0], p1) and torch.equal(first[1], l1)
              and torch.equal(first[2], linrec_mm.linrec_carry_scan(p1, l1)),
              f"B14+B15 fused at nb={nb1}: != B14 then B15")
        check(all(all(map(torch.equal, linrec_mm.linrec_summaries_carries(ab, bb), first))
                  for _ in range(5)), f"B14+B15 fused at nb={nb1}: five calls not bit-equal")
        fused[f"nb{nb1}"] = {"s": s1, "block_tiles": bt1, "bit_equal_to_b14_then_b15": True,
                             "repeat_calls_bit_equal": 5}
        del ab, bb, first, p1, l1
    # controls: the plain scan of the random rows with their operands rounded to
    # bf16 or TF32 must fail the limit above
    a, b = inputs["random"]
    ref, scale = lin_ref64(a, b), lin_ref64(a.abs(), b.abs())
    controls = {}
    for name, rnd in (("bf16_operands", lambda x: x.to(torch.bfloat16).float()),
                      ("tf32_operands", _round_tf32)):
        out = linrec_mm.linrec_scan_tiles_plain(rnd(a), rnd(b), s=s, acc=torch.float32)
        controls[name] = max_ulp_dev(out, ref, scale)
        check(controls[name] > limit,
              f"linrec fp32 limit {limit} ulp passes a {name} scan ({controls[name]} ulp)")
    del inputs, ref, scale
    rows_out = [linrec_rows(gen, limit), linrec_ssd_rows(gen, limit)]
    rows_out.append(linrec_operators(gen))
    single = linrec_single_pass(gen, limit)
    sync()
    emit({"phase": "linrec", "shape": list(SCAN_SHAPE), "ulp_limit": limit, "cases": cases,
          "fused_b14_b15": fused, "controls_max_ulp": controls, "rows": rows_out,
          "single_pass": single, "max_abs_err_vs_plain": worst})
    return worst


def linrec_single_pass(gen, limit) -> dict:
    """B13's single pass over tiles of ``linrec_scan_tile`` pairs linked by the
    look-back: one launch per case at and around the edge of its tiles (rows of 1,
    T - 1, T, T + 1 and 3 T + 17, batches of 1 and 64, integer-valued pairs with a
    zero of a on each tile's first pair), exact against the plain version and the
    fp64 recurrence; far more tiles than resident CTAs at (1, 2^26) and (64, 2^20),
    one CTA a tile, exact; five more fp32 calls at (4, 2^24) bit-equal to the first,
    within the ulp limit."""
    tile = linrec_mm.linrec_scan_tile(SCAN_SHAPE[1])
    cases = 0
    for b in (1, 64):
        for n in tile_edge_rows(tile):
            a = torch.randint(-1, 2, (b, n), generator=gen, device=DEV).float()
            bb = torch.randint(-3, 4, (b, n), generator=gen, device=DEV).float()
            a[:, tile::tile] = 0.0
            tag = f"B13 tile edge b={b} n={n}"
            ops.reset_launch_counts()
            got = linrec_mm.linrec_scan_tiles(a, bb)
            sync()
            expect_counts(ops.launch_counts(), tag, linrec_scan=1)
            check(torch.equal(got, linrec_mm.linrec_scan_tiles_plain(a, bb, s=16,
                                                                     acc=torch.float32))
                  and torch.equal(got.double(), lin_ref64(a, bb)),
                  f"{tag}: != plain or the fp64 recurrence")
            cases += 1
    progress = {}
    for shape in LINREC_PROGRESS_SHAPES:
        a = torch.randint(-1, 2, shape, generator=gen, device=DEV).float()
        bb = torch.randint(-3, 4, shape, generator=gen, device=DEV).float()
        tiles = shape[0] * -(-shape[1] // linrec_mm.linrec_scan_tile(shape[1]))
        ws = lookback.workspace(tiles, DEV, words=2)
        got = linrec_mm._linrec_scan_cuda(a, bb, ws=ws)
        sync()
        ctas = int(ws[-1])
        check(ctas == tiles, f"B13 at {shape}: {ctas} CTAs ran for {tiles} tiles")
        check(torch.equal(got.double(), lin_ref64(a, bb)), f"B13 at {shape}: not exact")
        progress[str(list(shape))] = {"tiles": tiles, "ctas": ctas}
        del a, bb, got
    a, bb = lin_inputs(gen, SCAN_SHAPE)["random"]
    first = linrec_mm.linrec_scan_tiles(a, bb)
    for i in range(5):
        check(torch.equal(linrec_mm.linrec_scan_tiles(a, bb), first),
              f"B13 fp32 call {i + 2} differs from the first")
    e = max_ulp_dev(first, lin_ref64(a, bb), lin_ref64(a.abs(), bb.abs()))
    check(e <= limit, f"B13 repeated calls: {e} ulp > {limit}")
    return {"tile": tile, "tile_edge_cases": cases, "forward_progress": progress,
            "repeat_calls_bit_equal": 5, "max_ulp": e,
            "ctas_a_row": -(-SCAN_SHAPE[1] // tile)}


def linrec_rows(gen, limit):
    """A ragged row and a one-block row through B13 and the pipeline, with exact launch
    counts: B14 launches only where a row has more than one block, B15's walk in its
    launch (``nb <= LINREC_FUSED_NB_MAX``), so B15 itself never."""
    out = []
    for n2 in (RAGGED_N, 100003):
        shape = (SCAN_SHAPE[0], n2)
        for kind, (a, b) in lin_inputs(gen, shape).items():
            if kind == "ones":
                continue
            ref, scale = lin_ref64(a, b), lin_ref64(a.abs(), b.abs())
            nb = scan_pipeline.block_geometry(n2, 128, 8)[2]
            row = {"n": n2, "input": kind, "nb": nb}
            for method, want in (("kernel", {"linrec_scan": 1}),
                                 ("blocked", {"linrec_block_scan": 1, **(
                                     {"linrec_summaries": 1} if nb > 1 else {})})):
                ops.reset_launch_counts()
                got = linear_scan(a, b, method=method)
                sync()
                expect_counts(ops.launch_counts(), f"linear_scan n={n2} {kind} {method}",
                              **want)
                if method == "blocked":
                    fused_walks(f"linear_scan n={n2} {kind}", int(nb > 1),
                                "linrec_summaries_carries")
                if kind == "int":
                    check(torch.equal(got.double(), ref),
                          f"linear_scan n={n2} int {method}: != the fp64 recurrence")
                else:
                    e = row[f"{method}_max_ulp"] = max_ulp_dev(got, ref, scale)
                    check(e <= limit, f"linear_scan n={n2} {method}: {e} ulp > {limit}")
            out.append(row)
    return {"case": "ragged and one-block rows", "rows": out}


def ssd_rows(gen, kind):
    """The SSD's cross-chunk pairs at zamba2's prefill: a chunk decay shared by the
    (64, 64) state, scanned along axis 1 (16 chunks); and the same pairs as the
    ``(2^20, 16)`` rows that the kernel methods of ``linear_scan`` hand over."""
    b5, nc, h, nn, pp = SSD_ROWS
    if kind == "int":
        a = torch.randint(-1, 2, (b5, nc, h, 1, 1), generator=gen, device=DEV).float()
        b = torch.randint(-3, 4, SSD_ROWS, generator=gen, device=DEV).float()
    else:
        a = 0.9 + 0.1 * torch.rand((b5, nc, h, 1, 1), generator=gen, device=DEV)
        b = torch.randn(SSD_ROWS, generator=gen, device=DEV)
    ar = torch.movedim(a.expand(SSD_ROWS), 1, -1).reshape(-1, nc).contiguous()
    br = torch.movedim(b, 1, -1).reshape(-1, nc).contiguous()
    return a, b, ar, br


def linrec_ssd_rows(gen, limit):
    """B13 and B16 at the SSD shape, through ``linear_scan`` along axis 1 as
    ``ssd_scan`` calls it: the column walk, one launch, against its plain version
    (``linrec_columns_plain``) and the fp64 recurrence of the same pairs as rows;
    integer values exact, random fp32 within the ulp limit, five more calls
    bit-equal.  Beside it the row path on the same pairs as ``(2^20, 16)`` rows
    (B13's and B16's warp walks, which rows of at most ``LINREC_WARP_MAX`` still
    take), against their plain versions and fp64 within the same limits."""
    res = {"case": "ssd shape", "shape": list(SSD_ROWS)}
    for kind in ("int", "random"):
        a, b, ar, br = ssd_rows(gen, kind)
        ref, scale = lin_ref64(ar, br), lin_ref64(ar.abs(), br.abs())
        nr, nn = ar.shape
        a4, b4 = ar.reshape(nr, 1, 1, nn), br.reshape(nr, 1, 1, nn)
        z = torch.zeros((nr, 1), device=DEV)
        for key, call, plain_rows in (
                ("linrec_scan", lambda: linrec_mm.linrec_scan_tiles(ar, br, s=16),
                 linrec_mm.linrec_scan_tiles_plain(ar, br, s=16, acc=torch.float32)),
                ("linrec_block_scan",
                 lambda: linrec_mm.linrec_block_scan_carry(a4, b4, z).reshape(nr, nn),
                 linrec_mm.linrec_block_scan_carry_plain(a4, b4, z, torch.float32)
                 .reshape(nr, nn))):
            ops.reset_launch_counts()
            got = call()
            sync()
            expect_counts(ops.launch_counts(), f"ssd rows {kind} {key} warp walk", **{key: 1})
            if kind == "int":
                check(torch.equal(got, plain_rows) and torch.equal(got.double(), ref),
                      f"ssd rows int {key} warp walk: != plain or the fp64 recurrence")
            else:
                e = res[f"rows_{key}_max_ulp"] = max_ulp_dev(got, ref, scale)
                res[f"rows_{key}_plain_max_ulp"] = max_ulp_dev(plain_rows, ref, scale)
                res[f"rows_{key}_max_abs_err_vs_plain"] = float((got - plain_rows).abs().max())
                check(e <= limit, f"ssd rows {key} warp walk: {e} ulp > {limit}")
        del a4, b4, z, got, plain_rows
        plain = linrec_mm.linrec_columns_plain(a, b, 1)
        prows = torch.movedim(plain, 1, -1).reshape(-1, SSD_ROWS[1])
        for method, key in (("kernel", "linrec_scan"), ("blocked", "linrec_block_scan")):
            ops.reset_launch_counts()
            got = linear_scan(a, b, axis=1, method=method, tile_s=16)
            sync()
            expect_counts(ops.launch_counts(), f"linear_scan ssd {kind} {method}", **{key: 1})
            rows = torch.movedim(got, 1, -1).reshape(-1, SSD_ROWS[1])
            if kind == "int":
                check(torch.equal(got, plain) and torch.equal(rows.double(), ref),
                      f"ssd rows int {method}: != plain or the fp64 recurrence")
            else:
                e = res[f"{method}_max_ulp"] = max_ulp_dev(rows, ref, scale)
                res[f"{method}_plain_max_ulp"] = max_ulp_dev(prows, ref, scale)
                res[f"{method}_max_abs_err_vs_plain"] = float((got - plain).abs().max())
                check(e <= limit, f"ssd rows {method}: {e} ulp > {limit}")
                for i in range(5):
                    check(torch.equal(linear_scan(a, b, axis=1, method=method, tile_s=16), got),
                          f"ssd rows {method}: call {i + 2} differs from the first")
    return res


def linrec_operators(gen):
    """``cumprod`` and ``segment_linear_scan`` on "kernel" and "blocked" against exact
    references, and ``cummax`` bit-identical on every method."""
    shape = (SCAN_SHAPE[0], 1 << 20)
    x = torch.randint(-1, 2, shape, generator=gen, device=DEV).float()
    x[x == 0] = 1.0
    x[:, 7919] = 0.0
    rng = np.random.default_rng(SEG_SEED + 3)
    off = seg_offsets(rng, shape[1])
    a = torch.randint(-1, 2, shape, generator=gen, device=DEV).float()
    b = torch.randint(-3, 4, shape, generator=gen, device=DEV).float()
    seg_want = segment_linear_scan(a, b, off, method="vector", initial=2.0)
    res = {"case": "operators", "shape": list(shape), "segments": int(off.numel() - 1)}
    for method in ("kernel", "blocked"):
        check(torch.equal(cumprod(x, method=method), torch.cumprod(x, -1)),
              f"cumprod {method} != torch.cumprod")
        check(torch.equal(segment_linear_scan(a, b, off, method=method, initial=2.0),
                          seg_want), f"segment_linear_scan {method} != vector")
    for dt in (torch.int32, torch.float32):
        xm = torch.randint(-1000, 1000, shape, generator=gen, device=DEV).to(dt)
        want = torch.cummax(xm, -1).values
        for method in ("vector", "matmul", "kernel", "blocked"):
            check(torch.equal(cummax(xm, method=method), want),
                  f"cummax {dt} {method} != torch.cummax")
    res["exact"] = True
    return res


# ---------------------------------------------------------------------------
# guards: the non-finite policies on the kernel paths, the overflow rows, the
# samplers at llama3-8b's vocabulary
# ---------------------------------------------------------------------------

GUARD_FRAC = 2.0 ** -20             # inject_nonfinite: 64 poisoned elements of (4, 2^24)
GUARD_SEED = 31
GUARD_KINDS = ("nan", "inf", "-inf")
GUARD_REPS = 5
# The reference each kernel path's propagate placement equals exactly, chosen
# from the card's first run of this phase (PERF.md §6): "fp64", the sequential
# fp64 scan or recurrence rounded to fp32, or "plain", the path's plain version
# on the card.
PROPAGATE_REF = {"scan/kernel": "fp64", "scan/blocked": "fp64",
                 "segment_scan/kernel": "fp64", "segment_scan/blocked": "fp64",
                 "linear_scan/kernel": "fp64", "linear_scan/blocked": "fp64",
                 "segment_linear_scan/kernel": "fp64", "segment_linear_scan/blocked": "fp64"}
# The same for the first inf and first NaN step of the overflow rows: "fp64", or
# "fold32", the affine fold of the pairs in fp32 applied to the zero state, which
# is what B13-B16 compute (past an overflowed product, inf·0 = NaN where the
# sequential recurrence keeps inf); every path's first inf step also equals fp64's.
OVERFLOW_REF = {"B13": "fold32", "B14-B16": "fold32", "columns/kernel": "fp64",
                "columns/blocked": "fp64"}


def _refused(fn) -> bool:
    """Whether ``fn()`` raises ``NonFiniteError`` (the ``"raise"`` policy)."""
    try:
        fn()
    except guards.NonFiniteError:
        return True
    return False


def placement(y) -> dict:
    """Where the non-finite values of ``y`` (rows, n) lie: each row's first
    non-finite index (-1 where none) and the counts of NaN, +inf and -inf."""
    bad = ~torch.isfinite(y)
    first = torch.where(bad.any(-1), bad.int().argmax(-1), -1)
    return {"first": first.tolist(), "nan": int(torch.isnan(y).sum()),
            "posinf": int(torch.isposinf(y).sum()), "neginf": int(torch.isneginf(y).sum())}


def same_placement(a, b) -> bool:
    return all(torch.equal(f(a), f(b)) for f in (torch.isnan, torch.isposinf, torch.isneginf))


def guard_path(path, clean, poison, poison_p, call, sanitized, plain, ref64, scale, want):
    """One kernel path under the three policies.  ``call(*operands, **kw)`` is the
    public entry point; ``poison(kind)`` gives the operands that ``raise`` and
    ``sanitize`` see, ``poison_p(kind)`` those of ``propagate``; ``sanitized``
    writes each operand's identity over its non-finite elements; ``plain`` and
    ``ref64`` are the path's plain version and fp64 sequential reference;
    ``scale`` the reference's scale on the clean operands.

    * raise: ``NonFiniteError`` with every launch counter still 0;
    * sanitize: finite, bit-equal to ``propagate`` on the sanitized operands,
      with the same launches (``want``);
    * propagate: NaN, +inf and -inf exactly where ``PROPAGATE_REF[path]`` puts
      them, finite elements within ``B1_F32_ULP`` of fp64."""
    res = {"reference": PROPAGATE_REF[path]}
    for kind in GUARD_KINDS:
        bad = poison(kind)
        ops.reset_launch_counts()
        check(_refused(lambda: call(*bad, nonfinite="raise")),
              f"guards {path} {kind}: nonfinite='raise' did not raise")
        sync()
        expect_counts(ops.launch_counts(), f"guards {path} {kind} raise")
        ops.reset_launch_counts()
        got = call(*bad, nonfinite="sanitize")
        sync()
        expect_counts(ops.launch_counts(), f"guards {path} {kind} sanitize", **want)
        ops.reset_launch_counts()
        ref = call(*sanitized(bad))
        sync()
        expect_counts(ops.launch_counts(), f"guards {path} {kind} on sanitized input", **want)
        check(torch.equal(got, ref) and bool(torch.isfinite(got).all()),
              f"guards {path} {kind}: sanitize != the same method on the sanitized input")
        del got, ref, bad
        badp = poison_p(kind)
        ops.reset_launch_counts()
        out = call(*badp)
        sync()
        expect_counts(ops.launch_counts(), f"guards {path} {kind} propagate", **want)
        r64 = ref64(*badp)
        refs = {"fp64": r64.float(), "plain": plain(*badp)}
        rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
        got_at = placement(rows(out))
        at = {k: placement(rows(r)) for k, r in refs.items()}
        equal = {k: same_placement(out, r) for k, r in refs.items()}
        fin = torch.isfinite(out) & torch.isfinite(r64)
        e = max_ulp_dev(out[fin], r64[fin], scale[fin]) if bool(fin.any()) else 0.0
        poisoned = torch.stack([~torch.isfinite(t) for t in badp if t.is_floating_point()]
                               ).any(0)
        res[kind] = {"poisoned": int(poisoned.sum()),
                     "first_poisoned": placement(rows(torch.where(
                         poisoned, float("nan"), 0.0)))["first"],
                     "kernel": got_at, **{f"{k}_ref": v for k, v in at.items()},
                     "equal": equal, "finite_max_ulp": e}
        check(equal[res["reference"]],
              f"guards {path} {kind}: propagate puts NaN/inf {got_at}, its "
              f"{res['reference']} reference {at[res['reference']]}")
        check(e <= B1_F32_ULP, f"guards {path} {kind}: finite elements {e} ulp > "
              f"{B1_F32_ULP}")
        del out, r64, refs, badp
    ms = {}
    for pol in guards.NONFINITE:
        ms[pol] = cuda_ms(lambda: call(*clean, nonfinite=pol), GUARD_REPS)
    res["ms_clean"] = ms
    return res


def guard_operators(gen) -> dict:
    """``scan``, ``segment_scan``, ``linear_scan`` and ``segment_linear_scan`` on
    "kernel" and "blocked" at (4, 2^24) fp32 under each policy (``guard_path``), the
    inputs poisoned by ``inject_nonfinite``.  The recurrences' propagate rows poison
    ``b`` only, with ``a`` in [1 - 2^-20, 1] (no product of a row underflows); raise
    and sanitize poison ``a`` and ``b``."""
    rows, n = SCAN_SHAPE
    f32 = torch.float32
    out = {}
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    scale = x.double().abs().cumsum(-1)

    def inj(t, kind, seed=GUARD_SEED):
        return inject_nonfinite(t, kind, frac=GUARD_FRAC, seed=seed)

    def zero_fill(ops_):
        return [torch.where(torch.isfinite(t), t, 0.0) for t in ops_]

    plain_scan = {
        "kernel": lambda t: scan_mm.scan_tiles_plain(t, s=128, variant="scanul1", acc=f32),
        "blocked": lambda t: scan_pipeline.blocked_scan_plain(t, s=128, block_tiles=8,
                                                              variant="scanul1", acc=f32)}
    want_scan = {"kernel": {"scan_mm": 1},
                 "blocked": {"block_sums": 1, "block_scan": 1}}
    for m in ("kernel", "blocked"):
        out[f"scan/{m}"] = guard_path(
            f"scan/{m}", (x,), lambda k: (inj(x, k),), lambda k: (inj(x, k),),
            lambda t, m=m, **kw: scan(t, method=m, **kw), zero_fill, plain_scan[m],
            lambda t: t.double().cumsum(-1), scale, want_scan[m])
    del scale
    # the four rows packed as one batch of segments, as main_segmented
    rng = np.random.default_rng(SEG_SEED + 3)
    xs = x.reshape(-1)
    off = torch.cat([seg_offsets(rng, n)[:-1] + r * n for r in range(rows)]
                    + [torch.tensor([rows * n], dtype=torch.int32, device=DEV)])
    flags = boundary_flags(off, rows * n)[None]
    _, sscale = seg_ref64(xs[None], flags)
    plain_seg = {
        "kernel": lambda t: segscan_mm.seg_scan_tiles_plain(t[None], flags != 0, s=128,
                                                            acc=f32)[0],
        "blocked": lambda t: segscan_mm.seg_blocked_scan_plain(t[None], flags != 0, s=128,
                                                               block_tiles=8, acc=f32)[0]}
    want_seg = {"kernel": {"seg_scan": 1},
                "blocked": {"seg_summaries": 1, "seg_carry": 1, "seg_block_scan": 1}}
    for m in ("kernel", "blocked"):
        out[f"segment_scan/{m}"] = guard_path(
            f"segment_scan/{m}", (xs,), lambda k: (inj(xs, k),), lambda k: (inj(xs, k),),
            lambda t, m=m, **kw: segment_scan(t, off, method=m, **kw), zero_fill,
            plain_seg[m], lambda t: seg_ref64(t[None], flags)[0][0], sscale[0],
            want_seg[m])
    out["segment_scan/kernel"]["segments"] = int(off.numel() - 1)
    del sscale, flags, xs
    a = 1.0 - 2.0 ** -20 * torch.rand(SCAN_SHAPE, generator=gen, device=DEV)
    b = x
    lscale = lin_ref64(a.abs(), b.abs())
    plain_lin = {
        "kernel": lambda aa, bb: linrec_mm.linrec_scan_tiles_plain(aa, bb, s=128, acc=f32),
        "blocked": lambda aa, bb: linrec_mm.linrec_blocked_scan_plain(aa, bb, s=128,
                                                                      block_tiles=8,
                                                                      acc=f32)}
    want_lin = {"kernel": {"linrec_scan": 1},
                "blocked": {"linrec_summaries": 1, "linrec_block_scan": 1}}
    for m in ("kernel", "blocked"):
        out[f"linear_scan/{m}"] = guard_path(
            f"linear_scan/{m}", (a, b), lambda k: (inj(a, k, GUARD_SEED + 1), inj(b, k)),
            lambda k: (a, inj(b, k)),
            lambda aa, bb, m=m, **kw: linear_scan(aa, bb, method=m, **kw),
            lambda ab: [torch.where(torch.isfinite(ab[0]), ab[0], 1.0),
                        torch.where(torch.isfinite(ab[1]), ab[1], 0.0)],
            plain_lin[m], lin_ref64, lscale, want_lin[m])
    # segment_linear_scan: the same rows cut into segments (offsets shared by the
    # rows); it zeroes a at each segment start and runs linear_scan, so its
    # references are the recurrence of the cut rows
    soff = seg_offsets(np.random.default_rng(SEG_SEED + 4), n)
    starts = boundary_flags(soff, n) > 0

    def cut(aa):
        return torch.where(starts, 0.0, aa)

    sl_scale = lin_ref64(cut(a).abs(), b.abs())
    for m in ("kernel", "blocked"):
        out[f"segment_linear_scan/{m}"] = guard_path(
            f"segment_linear_scan/{m}", (a, b),
            lambda k: (inj(a, k, GUARD_SEED + 1), inj(b, k)), lambda k: (a, inj(b, k)),
            lambda aa, bb, m=m, **kw: segment_linear_scan(aa, bb, soff, method=m, **kw),
            lambda ab: [torch.where(torch.isfinite(ab[0]), ab[0], 1.0),
                        torch.where(torch.isfinite(ab[1]), ab[1], 0.0)],
            lambda aa, bb, m=m: plain_lin[m](cut(aa), bb),
            lambda aa, bb: lin_ref64(cut(aa), bb), sl_scale, want_lin[m])
    out["segment_linear_scan/kernel"]["segments"] = int(soff.numel() - 1)
    return out


def first_steps(y, axis: int = -1) -> dict:
    """The first step along ``axis`` at which ``y`` holds ±inf and NaN (None where
    none), taken over every row; and whether every row has the same steps."""
    y = torch.movedim(y, axis, -1).reshape(-1, y.shape[axis])
    res = {}
    for name, mask in (("first_inf", torch.isinf(y)), ("first_nan", torch.isnan(y))):
        hit = mask.any(-1)
        steps = torch.where(hit, mask.int().argmax(-1), -1)
        res[name] = None if not bool(hit.any()) else int(steps[hit].min())
        res[f"{name}_same_on_every_row"] = bool((steps == steps[0]).all())
    return res


def seq_steps64(a: float, b: float, n: int) -> dict:
    """``first_steps`` of the sequential fp64 recurrence ``y_t = a y_{t-1} + b`` from
    ``y_{-1} = 0``, each value rounded to fp32, walked until it stops changing."""
    y, res = 0.0, {"first_inf": None, "first_nan": None}
    for t in range(n):
        prev, y = y, a * y + b
        v = float(torch.tensor(y, dtype=torch.float64).float())
        if res["first_inf"] is None and math.isinf(v):
            res["first_inf"] = t
        if res["first_nan"] is None and math.isnan(v):
            res["first_nan"] = t
        if y == prev or math.isnan(y):
            break
    return res


def fold_steps32(a: float, b: float, n: int) -> dict:
    """``first_steps`` of the recurrence computed as the kernels' affine fold: in
    fp32, ``y_t = A_t · y_{-1} + B_t`` with ``y_{-1} = 0``, ``A_t`` the product of
    the multipliers before step ``t`` and ``B_t = a B_{t-1} + b``, walked until it
    stops changing."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    big, bb, y = 1.0, 0.0, 0.0
    res = {"first_inf": None, "first_nan": None}
    for t in range(n):
        prev = (big, bb)
        if t:
            big = f32(big * a)
        bb = f32(a * bb + b)
        y = f32(big * 0.0 + bb)                   # inf·0 = NaN past an overflow
        if res["first_inf"] is None and math.isinf(y):
            res["first_inf"] = t
        if res["first_nan"] is None and math.isnan(y):
            res["first_nan"] = t
        if (big, bb) == prev and t:
            break
    return res


def overflow_rows() -> list:
    """ROADMAP Queue C's overflow rows: ``a ≡ 2`` with ``b ≡ 1`` and ``b ≡ 0``, 300 long
    and at (4, 2^24), through B13 (``linear_scan(method="kernel")``) and B14-B16
    (``"blocked"``); and the column walk at the SSD's (4, 16, 64, 64, 64) shape
    along axis 1, with ``a ≡ 2`` (16 steps cannot overflow) and ``a ≡ 512``
    (overflows at step 15).  Each path's first inf and first NaN step equal those
    of its ``OVERFLOW_REF`` reference, and its first inf step that of the fp64
    sequential recurrence; the plain versions' steps are printed beside them."""
    f32 = torch.float32
    res = []

    def hold(path, got, plain_out, seq, fold, axis=-1):
        steps = first_steps(got, axis)
        refs = {"fp64": seq, "fold32": fold, "plain": first_steps(plain_out, axis)}
        chosen = OVERFLOW_REF[path]
        equal = {k: all(steps[key] == r[key] for key in ("first_inf", "first_nan"))
                 for k, r in refs.items()}
        check(steps["first_inf_same_on_every_row"] and steps["first_nan_same_on_every_row"],
              f"overflow {path}: rows of equal inputs overflow at different steps: {steps}")
        check(equal[chosen] and steps["first_inf"] == seq["first_inf"],
              f"overflow {path}: steps {steps} != its {chosen} reference {refs[chosen]} "
              f"(fp64: {seq})")
        return {"kernel": steps, **refs, "equal": equal, "reference": chosen}

    for av, bv in ((2.0, 1.0), (2.0, 0.0)):
        for shape in ((1, 300), SCAN_SHAPE):
            a = torch.full(shape, av, device=DEV)
            b = torch.full(shape, bv, device=DEV)
            seq, fold = seq_steps64(av, bv, shape[-1]), fold_steps32(av, bv, shape[-1])
            case = {"a": av, "b": bv, "shape": list(shape)}
            for path, m, plain in (
                    ("B13", "kernel", lambda: linrec_mm.linrec_scan_tiles_plain(
                        a, b, s=128, acc=f32)),
                    ("B14-B16", "blocked", lambda: linrec_mm.linrec_blocked_scan_plain(
                        a, b, s=128, block_tiles=8, acc=f32))):
                got = linear_scan(a, b, method=m)
                case[path] = hold(path, got, plain(), seq, fold)
                del got
            res.append(case)
            del a, b
    b5, nc, h, _, _ = SSD_ROWS
    for av, bv in ((2.0, 1.0), (2.0, 0.0), (512.0, 1.0), (512.0, 0.0)):
        a = torch.full((b5, nc, h, 1, 1), av, device=DEV)
        b = torch.full(SSD_ROWS, bv, device=DEV)
        seq, fold = seq_steps64(av, bv, nc), fold_steps32(av, bv, nc)
        case = {"a": av, "b": bv, "shape": list(SSD_ROWS), "axis": 1}
        plain = linrec_mm.linrec_columns_plain(a, b, 1)
        for m, key in (("kernel", "linrec_scan"), ("blocked", "linrec_block_scan")):
            ops.reset_launch_counts()
            got = linear_scan(a, b, axis=1, method=m, tile_s=16)
            sync()
            expect_counts(ops.launch_counts(), f"overflow column walk {m}", **{key: 1})
            case[f"columns/{m}"] = hold(f"columns/{m}", got, plain, seq, fold, axis=1)
        res.append(case)
        del a, b, plain, got
    return res


def guard_rows(gen, vocab: int):
    """The sampler rows at a vocabulary of ``vocab``: clean, its second half masked
    with -inf, fully -inf, and poisoned with NaN (``inject_nonfinite``); and their
    uniforms."""
    rows = torch.randn((4, vocab), generator=gen, device=DEV) * 2.0
    rows[1, vocab // 2:] = float("-inf")
    rows[2] = float("-inf")
    rows[3] = inject_nonfinite(rows[3], "nan", frac=2.0 ** -10, seed=GUARD_SEED)
    return rows, torch.rand((4, 1), generator=gen, device=DEV)


def greedy_tokens(rows):
    """The greedy token of each row: the first maximum, NaN read as -inf."""
    return torch.argmax(torch.where(torch.isnan(rows), float("-inf"), rows), -1)


def cdf_window(w, u):
    """The least and greatest index that inverse-transform sampling of ``w`` may
    return for ``u``: the indices whose fp64 CDF value lies within
    ``TOPP_BAND`` of the row's mass of ``u`` times that mass."""
    c = w.double().cumsum(-1)
    total = c[:, -1:]
    theta, d = u.double() * total, split_mm.TOPP_BAND * total
    n = w.shape[-1] - 1
    return ((c < theta - d).sum(-1).clamp(max=n).cpu().numpy(),
            (c < theta + d).sum(-1).clamp(max=n).cpu().numpy())


def guard_samplers(gen) -> dict:
    """``top_p_sample(method="kernel")`` (B7 + B8), ``segment_top_p_sample(
    method="kernel")`` on the same rows packed (B9) and ``weighted_sample(
    method="kernel")`` on their softmax (B1), at (4, 128256): ``raise`` refuses
    the four rows before any launch and passes the clean and half-masked rows
    alone; ``sanitize`` gives each poisoned row its greedy token, the others a
    token inside the band's window, with the launches of ``propagate``."""
    rows, u = guard_rows(gen, VOCAB)
    greedy = greedy_tokens(rows)
    clean = torch.randn((4, VOCAB), generator=gen, device=DEV) * 2.0

    def packed(r, uu, **kw):
        off = torch.arange(r.shape[0] + 1, dtype=torch.int32, device=DEV) * r.shape[1]
        return segment_top_p_sample(r.reshape(-1), off, p=0.9, u=uu, method="kernel", **kw)

    samplers = {
        "top_p_sample": (lambda r, uu, **kw: top_p_sample(r, p=0.9, u=uu, method="kernel",
                                                          **kw),
                         {"radix_pass": 4, "topp_tail": 1}),
        "segment_top_p_sample": (packed, {"seg_scan": 8}),
        "weighted_sample": (lambda r, uu, **kw: weighted_sample(
            torch.softmax(r, -1), u=uu, method="kernel", **kw), {"scan_mm": 1}),
    }
    res = {}
    for name, (fn, want) in samplers.items():
        ops.reset_launch_counts()
        check(_refused(lambda: fn(rows, u, nonfinite="raise")),
              f"guards {name}: nonfinite='raise' passed poisoned rows")
        sync()
        expect_counts(ops.launch_counts(), f"guards {name} raise")
        tr = fn(rows[:2], u[:2], nonfinite="raise")
        ops.reset_launch_counts()
        ts = fn(rows, u, nonfinite="sanitize")
        sync()
        expect_counts(ops.launch_counts(), f"guards {name} sanitize", **want)
        ops.reset_launch_counts()
        tp = fn(rows, u)
        sync()
        expect_counts(ops.launch_counts(), f"guards {name} propagate", **want)
        if name == "weighted_sample":
            w = torch.softmax(rows, -1)
            gw = torch.argmax(torch.where(torch.isfinite(w), w, 0.0), -1)
            check(torch.equal(ts[2:].long(), gw[2:]),
                  f"guards {name}: sanitize gave the poisoned rows {ts[2:].tolist()}, "
                  f"not their greedy index {gw[2:].tolist()}")
            lo, hi = cdf_window(w[:2], u[:2])
            for t in (ts[:2], tr):
                j = t.long().cpu().numpy()
                check(((lo <= j) & (j <= hi)).all(), f"guards {name}: index {j.tolist()} "
                      f"outside the window {lo.tolist()}..{hi.tolist()}")
            held = {"window": [lo.tolist(), hi.tolist()]}
        else:
            check(torch.equal(ts[2:].long(), greedy[2:]),
                  f"guards {name}: sanitize gave the poisoned rows {ts[2:].tolist()}, not "
                  f"their greedy token {greedy[2:].tolist()}")
            held = hold_steps([(rows[:2], u[:2], ts[:2]), (rows[:2], u[:2], tr)], 0.9,
                              f"guards {name}", masks=True)
        ms = {pol: cuda_ms(lambda: fn(clean, u, nonfinite=pol), GUARD_REPS)
              for pol in guards.NONFINITE}
        res[name] = {"sanitize": ts.tolist(), "raise_rows_0_1": tr.tolist(),
                     "propagate": tp.tolist(), "greedy": greedy.tolist(), **held,
                     "launches": _nonzero(want), "ms_clean_rows": ms}
    return res


def phase_guards(gen):
    """The ``guards`` phase: the non-finite policies on B1-B4, B9-B12 and B13-B16 at
    (4, 2^24), Queue C's overflow rows, and the samplers at llama3-8b's vocabulary."""
    t0 = time.perf_counter()
    res = {"operators": guard_operators(gen)}
    res["overflow"] = overflow_rows()
    res["samplers"] = guard_samplers(gen)
    sync()
    emit({"phase": "guards", "shape": list(SCAN_SHAPE), "frac": GUARD_FRAC,
          "ulp_limit": B1_F32_ULP, **res, "seconds": time.perf_counter() - t0})
    return res


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------


def main_scan(gen):
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    ops.reset_launch_counts()
    out = scan(x, method="kernel")
    sync()
    counts = ops.launch_counts()
    check(counts["scan_mm"] >= 1, "scan(method='kernel') launched no B1 kernel")
    check(out.shape == x.shape and out.dtype == torch.float32 and bool(out.isfinite().all()),
          "scan(method='kernel') output has the wrong shape or non-finite values")
    err = float((out[:, -1].double() - x.double().sum(-1)).abs().max())
    emit({"phase": "main_scan", "shape": list(SCAN_SHAPE), "launches": counts,
          "abs_err_of_row_totals": err})
    return counts


def main_blocked(gen):
    """``scan(method="blocked")`` and ``compress`` through B5 and through the
    pipeline, each with the counters zeroed just before and read just after."""
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    mask = torch.rand(SCAN_SHAPE, generator=gen, device=DEV) < 0.5
    runs = {}
    ops.reset_launch_counts()
    out = scan(x, method="blocked")
    sync()
    runs["scan"] = ops.launch_counts()
    expect_counts(runs["scan"], "scan(method='blocked')", block_sums=1, block_scan=1)
    walks = fused_walks("scan(method='blocked')", 1)
    check(out.shape == x.shape and out.dtype == torch.float32 and bool(out.isfinite().all()),
          "scan(method='blocked') output has the wrong shape or non-finite values")
    err = float((out[:, -1].double() - x.double().sum(-1)).abs().max())
    ops.reset_launch_counts()
    vk, kk = compress(x, mask, method="kernel")
    sync()
    runs["compress_kernel"] = ops.launch_counts()
    expect_counts(runs["compress_kernel"], "compress(method='kernel')", split=1)
    ops.reset_launch_counts()
    vb, kb = compress(x, mask, method="blocked")
    sync()
    runs["compress_blocked"] = ops.launch_counts()
    expect_counts(runs["compress_blocked"], "compress(method='blocked')", block_sums=1,
                  block_scan=1)
    walks += fused_walks("compress(method='blocked')", 1)
    check(torch.equal(kk.long(), mask.sum(-1)) and torch.equal(kk, kb) and torch.equal(vk, vb),
          "compress: the kernel and blocked paths disagree")
    for r in range(SCAN_SHAPE[0]):
        k = int(kk[r])
        check(torch.equal(vk[r, :k], x[r][mask[r]]) and not bool(vk[r, k:].any()),
              f"compress row {r}: not the masked elements packed left, zeros after")
    emit({"phase": "main_blocked", "shape": list(SCAN_SHAPE), "launches": runs,
          "fused_b2_b3_launches": walks, "abs_err_of_row_totals": err,
          "n_true": kk.tolist()})
    return {**{k: sum(c[k] for c in runs.values()) for k in ops.KERNELS},
            "carry_walks": walks}


def main_segmented(gen):
    """``segment_compress`` through B9 and through B10-B12 on the four (4, 2^24) rows
    packed as one batch, each with the counters zeroed just before and read just
    after; the two agree, and every segment equals the port's ``compress`` of it."""
    rng = np.random.default_rng(SEG_SEED + 1)
    b, n = SCAN_SHAPE
    x = torch.randn((b * n,), generator=gen, device=DEV)
    mask = torch.rand((b * n,), generator=gen, device=DEV) < 0.5
    off = torch.cat([seg_offsets(rng, n)[:-1] + r * n for r in range(b)]
                    + [torch.tensor([b * n], dtype=torch.int32, device=DEV)])
    runs = {}
    ops.reset_launch_counts()
    zk, ck = segment_compress(x, mask, off, method="kernel")
    sync()
    runs["segment_compress_kernel"] = ops.launch_counts()
    expect_counts(runs["segment_compress_kernel"], "segment_compress(method='kernel')",
                  seg_scan=1)
    ops.reset_launch_counts()
    zb, cb = segment_compress(x, mask, off, method="blocked")
    sync()
    runs["segment_compress_blocked"] = ops.launch_counts()
    expect_counts(runs["segment_compress_blocked"], "segment_compress(method='blocked')",
                  seg_summaries=1, seg_carry=1, seg_block_scan=1)
    check(torch.equal(zk, zb) and torch.equal(ck, cb),
          "segment_compress: the kernel and blocked paths disagree")
    bounds = off.tolist()
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi > lo:
            v, k = compress(x[lo:hi], mask[lo:hi], method="vector")
            check(int(k) == int(ck[i]) and torch.equal(zk[lo:hi], v),
                  f"segment_compress segment {i}: != compress of the segment")
        else:
            check(int(ck[i]) == 0, f"segment_compress: empty segment {i} keeps {int(ck[i])}")
    emit({"phase": "main_segmented", "packed_n": b * n, "segments": len(bounds) - 1,
          "empty_segments": int((off[1:] == off[:-1]).sum()), "launches": runs,
          "kept": int(ck.sum())})
    return {k: sum(c[k] for c in runs.values()) for k in ops.KERNELS}


def main_linrec(gen):
    """``linear_scan`` through the public entry on (4, 2^24) random rows: ``"kernel"``
    launches exactly one B13, ``"blocked"`` (128 blocks a row) exactly one B14, whose
    CTA that finishes a row runs B15's walk, and one B16; both within the ulp limit
    of the fp64 recurrence."""
    a, b = lin_inputs(gen, SCAN_SHAPE)["random"]
    ref, scale = lin_ref64(a, b), lin_ref64(a.abs(), b.abs())
    runs, res = {}, {}
    walks = 0
    for method, want in (("kernel", {"linrec_scan": 1}),
                         ("blocked", {"linrec_summaries": 1, "linrec_block_scan": 1})):
        ops.reset_launch_counts()
        out = linear_scan(a, b, method=method)
        sync()
        runs[method] = ops.launch_counts()
        expect_counts(runs[method], f"linear_scan(method={method!r})", **want)
        if method == "blocked":
            walks = fused_walks("linear_scan(method='blocked')", 1,
                                "linrec_summaries_carries")
        check(out.shape == a.shape and out.dtype == torch.float32
              and bool(out.isfinite().all()),
              f"linear_scan({method}) output has the wrong shape or non-finite values")
        res[f"{method}_max_ulp"] = e = max_ulp_dev(out, ref, scale)
        check(e <= B1_F32_ULP, f"linear_scan({method}): {e} ulp > {B1_F32_ULP}")
    emit({"phase": "main_linrec", "shape": list(SCAN_SHAPE), "launches": runs,
          "fused_b14_b15_launches": walks, **res})
    return {**{k: sum(c[k] for c in runs.values()) for k in ops.KERNELS},
            "carry_walks": walks}


# ---------------------------------------------------------------------------
# method="auto" on the card: the table's "cuda" backend
# ---------------------------------------------------------------------------

AUTO_MAX_ELEMENTS = 1 << 24         # a call's elements in the resolution checks
AUTO_FACTOR = 4.0                   # gate (c): a default call within 4x of the fastest
AUTO_REPS = 10                      # eager calls a method at a spot point, in turns
AUTO_SERVE_STEPS = 4
AUTO_SPLIT_SHAPE = (4, 1 << 20)     # gate (c)'s split point
AUTO_SEG_N = 1 << 20                # gate (c)'s packed segment_scan
AUTO_LINREC_SHAPE = (4, 1 << 22)    # gate (c)'s linear_scan point


@contextlib.contextmanager
def resolutions():
    """Record every table resolution, ``(op, n, dtype, backend, method)``, made in
    the block (``maybe_resolve`` calls ``autotune.resolve_method`` by name)."""
    rec, orig = [], autotune.resolve_method

    def spy(op, n, dtype, *, backend):
        m = orig(op, n, dtype, backend=backend)
        rec.append((op, int(n), autotune.dtype_name(dtype), backend, m))
        return m

    autotune.resolve_method = spy
    try:
        yield rec
    finally:
        autotune.resolve_method = orig


def table_pick(table, op, n, dt):
    """The ``"cuda"`` backend's method for ``op`` at length ``n`` and dtype name
    ``dt``, read off the table by hand (the largest breakpoint <= n; a missing
    dtype falls to float32)."""
    optab = table["backends"]["cuda"][autotune.OP_ALIASES.get(op, op)]
    entries = optab.get(dt) or optab.get("float32") or optab[sorted(optab)[0]]
    m = entries[0][1]
    for b, mm in entries:
        if n >= b:
            m = mm
    return m


def auto_lengths(entries) -> list:
    """Every breakpoint of a bucket list and one length inside each bucket, up to
    ``AUTO_MAX_ELEMENTS``."""
    bps = [b for b, _ in entries]
    ns = set(bps)
    for lo, hi in zip(bps, bps[1:] + [None]):
        ns.add((lo + hi) // 2 if hi else min(2 * lo, AUTO_MAX_ELEMENTS))
    return sorted(n for n in ns if n <= AUTO_MAX_ELEMENTS)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def auto_call(op, n, dtype, gen):
    """The entry point of ``op`` on CUDA inputs of length ``n``: a function of the
    call's keyword arguments (none: the default call, ``method="auto"``)."""
    rows = max(1, min(4, AUTO_MAX_ELEMENTS // n))

    def pay(shape=(rows, n)):
        if dtype == torch.int8:
            return torch.randint(-100, 100, shape, generator=gen, device=DEV).to(dtype)
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    u = torch.rand((rows, 1), generator=gen, device=DEV)
    fam = autotune.OP_ALIASES.get(op, op)
    if fam == "segment_scan":
        segs = max(1, n // 1024)
        cuts = torch.sort(torch.randint(0, n + 1, (segs - 1,), generator=gen,
                                        device=DEV)).values
        off = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)]).to(torch.int32)
        x = pay((n,))
        mask = torch.rand((n,), generator=gen, device=DEV) < 0.5
        a = 0.9 + 0.1 * torch.rand((n,), generator=gen, device=DEV)
        us = torch.rand((segs, 1), generator=gen, device=DEV)
        return {
            "segment_scan": lambda **kw: segment_scan(x, off, **kw),
            "segment_cumsum": lambda **kw: segm.segment_cumsum(x, off, **kw),
            "segment_sums": lambda **kw: segm.segment_sums(x, off, **kw),
            "segment_softmax": lambda **kw: segm.segment_softmax(x, off, **kw),
            "segment_compress": lambda **kw: segment_compress(x, mask, off, **kw),
            "segment_sort": lambda **kw: segm.segment_sort(x, off, **kw),
            "segment_topk": lambda **kw: segm.segment_topk(x, off, k=2, **kw),
            "segment_top_p_sample": lambda **kw: segment_top_p_sample(x, off, u=us, **kw),
            "segment_linear_scan": lambda **kw: segment_linear_scan(a, x, off, **kw),
            # its own default is "vector": "auto" reaches the table only when asked
            "segment_ids": lambda **kw: segm.segment_ids(off, n, **({"method": "auto"}
                                                                   | kw)),
        }[op]
    x = pay()
    if fam == "scan":
        w = torch.rand((rows, n), generator=gen, device=DEV).to(dtype)
        return {"scan": lambda **kw: scan(x, **kw),
                "cumsum": lambda **kw: prim_cumsum(x, **kw),
                "weighted_sample": lambda **kw: weighted_sample(w, u=u, **kw)}[op]
    if fam == "split":
        mask = torch.rand((rows, n), generator=gen, device=DEV) < 0.5
        digits = torch.randint(0, B6_BUCKETS, (rows, n), generator=gen, device=DEV)
        return {"split": lambda **kw: prim.split(x, mask, **kw),
                "compress": lambda **kw: compress(x, mask, **kw),
                "multi_split": lambda **kw: multi_split(x, digits, B6_BUCKETS, **kw)}[op]
    if fam == "sort":
        return {"sort": lambda **kw: prim.sort(x, **kw),
                "radix_sort": lambda **kw: radix_sort(x, **kw),
                "topk": lambda **kw: prim.topk(x, min(8, n), **kw)}[op]
    if fam == "top_p_sample":
        logits = torch.randn((rows, n), generator=gen, device=DEV) * 3
        return lambda **kw: top_p_sample(logits, p=0.9, u=u, **kw)
    a = (0.9 + 0.1 * torch.rand((rows, n), generator=gen, device=DEV)).to(dtype)
    return {"linear_scan": lambda **kw: linear_scan(a, x, **kw),
            "cumprod": lambda **kw: cumprod(1.0 + 1e-3 * x, **kw),
            "cummax": lambda **kw: cummax(x, **kw)}[op]


def auto_table(smi: str) -> dict:
    """(a): the committed table is valid, its "cuda" backend covers the tuned ops and
    ``build_table`` on the committed sweep rows reproduces it."""
    table = autotune.load_table()
    probs = autotune.validate_table(table)
    check(not probs, f"auto: the tuning table is not valid: {probs}")
    check(set(autotune.TUNED_OPS) <= set(table["backends"]["cuda"]),
          f"auto: the cuda backend lacks {set(autotune.TUNED_OPS) - set(table['backends']['cuda'])}")
    with open(tune.sweep_path(autotune.default_table_path())) as f:
        sweep = json.load(f)
    built = autotune.build_table(sweep["rows"], backend="cuda")
    check(not built["fallbacks"] and built["backends"]["cuda"] == table["backends"]["cuda"],
          "auto: build_table on the committed sweep rows does not reproduce the cuda backend")
    print(f"auto: the table's cuda backend was measured on {sweep['provenance']['nvidia_smi']};"
          f" this run: {smi}", flush=True)
    return {"sweep_card": sweep["provenance"]["nvidia_smi"], "this_card": smi,
            "sweep_seconds": sweep["provenance"].get("sweep_seconds"),
            "buckets": table["backends"]["cuda"]}


def auto_resolution(gen, table) -> dict:
    """(b): every tuned op and alias, every dtype of its family in the table, at each
    breakpoint and inside each bucket: the default call resolves to the table's
    method, launches what the explicit call of that method launches, and is
    bit-equal to it.  The dist_* aliases are resolved only."""
    res = {}
    for op in sorted(set(autotune.TUNED_OPS) | set(autotune.OP_ALIASES)):
        fam = autotune.OP_ALIASES.get(op, op)
        for dt, entries in sorted(table["backends"]["cuda"][fam].items()):
            if op == "weighted_sample" and dt == "int8":
                continue                    # weights are probabilities: float only
            dtype = getattr(torch, dt)
            for n in auto_lengths(entries):
                want = table_pick(table, op, n, dt)
                key = f"{op}/{dt}/n={n}"
                if op.startswith("dist_"):
                    got = autotune.resolve_method(op, n, dtype, backend="cuda")
                    check(got == want, f"auto {key}: resolved {got}, the table says {want}")
                    res[key] = {"method": got}
                    continue
                fn = auto_call(op, n, dtype, gen)
                ops.reset_launch_counts()
                with resolutions() as rec:
                    out = fn()
                sync()
                counts = ops.launch_counts()
                check(rec and rec[0][1] == n and rec[0][4] == table_pick(table, *rec[0][:3]),
                      f"auto {key}: resolved {rec[:1]}, the table says otherwise")
                got = rec[0][4]
                ops.reset_launch_counts()
                ref = fn(method=got)
                sync()
                check(ops.launch_counts() == counts,
                      f"auto {key}: the default call launched {counts}, method={got!r} "
                      f"{ops.launch_counts()}")
                check(_same(out, ref), f"auto {key}: the default call != method={got!r}")
                res[key] = {"method": got, "resolved_as": list(rec[0][:3]),
                            "launches": {k: v for k, v in counts.items() if v}}
                del fn, out, ref
    return res


def auto_spots(gen) -> dict:
    """(c), the port of JAX's auto-vs-oracle gate (``tools/compare_bench.py
    --auto-factor 4``): at each point every method and the default call, eager, in
    turns; the default within ``AUTO_FACTOR`` of the fastest method."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device=DEV)

    x4k, x24, xl = rnd((4, 4096)), rnd(SCAN_SHAPE), rnd(AUTO_LINREC_SHAPE)
    s8 = torch.randint(-100, 100, AUTO_SPLIT_SHAPE, generator=gen, device=DEV).to(torch.int8)
    f8 = torch.rand(AUTO_SPLIT_SHAPE, generator=gen, device=DEV) < 0.5
    kb = rnd((4, VOCAB)).to(torch.bfloat16)
    logits = rnd((4, VOCAB)) * 3
    u = torch.rand((4, 1), generator=gen, device=DEV)
    n = AUTO_SEG_N
    cuts = torch.sort(torch.randint(0, n + 1, (n // 1024 - 1,), generator=gen,
                                    device=DEV)).values
    off = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)]).to(torch.int32)
    xs = rnd((n,))
    al = 0.9 + 0.1 * torch.rand(AUTO_LINREC_SHAPE, generator=gen, device=DEV)
    ssd_a = torch.exp(-torch.rand(SSD_ROWS[:3] + (1, 1), generator=gen, device=DEV))
    ssd_b = rnd(SSD_ROWS)
    points = {
        "scan float32 (4, 4096)": lambda **kw: scan(x4k, **kw),
        "scan float32 (4, 2^24)": lambda **kw: scan(x24, **kw),
        "split int8 (4, 2^20)": lambda **kw: prim.split(s8, f8, **kw),
        "sort bfloat16 (4, 128256)": lambda **kw: radix_sort(kb, **kw),
        "top_p_sample (4, 128256)": lambda **kw: top_p_sample(logits, p=0.9, u=u, **kw),
        "segment_scan 2^20 packed": lambda **kw: segment_scan(xs, off, **kw),
        "linear_scan float32 (4, 2^22)": lambda **kw: linear_scan(al, xl, **kw),
        "linear_scan SSD (4, 16, 64, 64, 64) axis 1": lambda **kw: linear_scan(
            ssd_a, ssd_b, axis=1, tile_s=SSD_ROWS[1], **kw),
    }
    res = {}
    for name, fn in points.items():
        calls = {m: (lambda m=m, fn=fn: fn(method=m)) for m in autotune.CONCRETE_METHODS}
        calls["auto"] = fn
        with resolutions() as rec:
            fn()
        times, oom = sweep.time_in_turns(calls, AUTO_REPS)
        check("auto" in times, f"auto {name}: the default call ran out of memory")
        ms = {m: statistics.median(t) * 1e3 for m, t in times.items()}
        fastest = min((m for m in autotune.CONCRETE_METHODS if m in ms), key=ms.get)
        ratio = ms["auto"] / ms[fastest]
        print(f"auto {name}: default ({rec[0][4]}) {ms['auto']:.4g} ms, fastest "
              f"({fastest}) {ms[fastest]:.4g} ms, ratio {ratio:.3f}", flush=True)
        res[name] = {"resolved": rec[0][4], "ms": ms, "fastest": fastest,
                     "ratio_to_fastest": ratio, "out_of_memory": oom}
        check(ratio <= AUTO_FACTOR, f"auto {name}: the default call ({rec[0][4]}) takes "
              f"{ratio:.2f}x the fastest method ({fastest}), over {AUTO_FACTOR}x")
        del calls
        torch.cuda.empty_cache()
    return res


def phase_auto(gen, smi: str) -> dict:
    """The ``auto`` phase: (a) the table, (b) resolution and launches, (c) spot times
    against the fastest method.  (d), the serving default, runs in ``auto_serving``
    on ``main_serve``'s weights."""
    t0 = time.perf_counter()
    res = {"table": auto_table(smi)}
    table = autotune.load_table()
    res["resolution"] = auto_resolution(gen, table)
    t_b = time.perf_counter() - t0
    res["spots"] = auto_spots(gen)
    by = collections.Counter(v["method"] for v in res["resolution"].values())
    launched = collections.Counter()
    for v in res["resolution"].values():
        launched.update(v.get("launches", {}))
    emit({"phase": "auto", "table": res["table"], "spots": res["spots"],
          "calls_checked": len(res["resolution"]), "calls_by_method": dict(by),
          "launches_of_default_calls": dict(launched), "resolution_seconds": t_b,
          "seconds": time.perf_counter() - t0})
    return res


def auto_serving(params, gen) -> dict:
    """(d): ``ServeEngine(sampler="topp_auto")`` for ``AUTO_SERVE_STEPS`` decode steps
    on llama3-8b: the method its sampler resolved, its launches (those of the
    engine whose sampler names that method explicitly, with the same tokens, where
    one exists), every token held to the band's window (``check_sampled``)."""
    cfg = get_config("llama3-8b")
    b, s, new = SERVE["batch"], SERVE["prompt"], AUTO_SERVE_STEPS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV)}
    uniforms = torch.rand((new, b), generator=gen, device=DEV)
    eng = ServeEngine(cfg, params, max_len=s + new, sampler="topp_auto")
    eng.generate(batch, 1, uniforms=uniforms[:1])                   # warm-up
    ops.reset_launch_counts()
    with resolutions() as rec:
        toks = eng.generate(batch, new, uniforms=uniforms)
    sync()
    counts = ops.launch_counts()
    picks = sorted({r for r in rec})
    check(len(picks) == 1 and picks[0][0] == "top_p_sample" and picks[0][1] == cfg.vocab_size,
          f"auto_serving: expected one resolution of top_p_sample at the vocabulary, got {picks}")
    method = picks[0][4]
    explicit = {"kernel": "topp_kernel", "blocked": "topp_blocked",
                "matmul": "topp_scan"}.get(method)
    same = None
    if explicit:
        e2 = ServeEngine(cfg, params, max_len=s + new, sampler=explicit)
        e2.generate(batch, 1, uniforms=uniforms[:1])
        ops.reset_launch_counts()
        t2 = e2.generate(batch, new, uniforms=uniforms)
        sync()
        check(ops.launch_counts() == counts, f"auto_serving: topp_auto ({method}) launched "
              f"{counts}, {explicit} {ops.launch_counts()}")
        same = torch.equal(t2, toks)
        check(same, f"auto_serving: topp_auto ({method}) and {explicit} drew other tokens")
    held = check_sampled(eng, batch, uniforms, toks, new)
    out = {"resolved": picks[0], "launches": {k: v for k, v in counts.items() if v},
           "explicit_sampler": explicit, "tokens_equal_to_explicit": same, "held": held}
    emit({"phase": "auto", "part": "serving", "arch": cfg.name, "batch": b, "prompt": s,
          "steps": new, **out})
    return out


# ---------------------------------------------------------------------------
# precision: "compensated" and "fast" on the kernel paths, "matmul", the split
# ---------------------------------------------------------------------------

PRECISION_MATMUL_SHAPE = (4, 1 << 20)   # "matmul"'s linrec triangles: 2 GiB a tensor
PRECISION_CPU_SHAPE = (2, 1 << 14)      # "matmul" on the card against the CPU's
PRECISION_SEED = 41                     # the phase's own inputs: later phases keep theirs
PRECISION_REPS = 5                      # eager calls a precision, in turns
PRECISION_AUTO = dict(vector=4096, kernel=1 << 20)   # the "cuda" table: scan fp32


def precision_inputs(gen, shape):
    """Each op's random fp32 call, its integer-valued call and their fp64 references
    and scales: the ``b1``/``seg``/``linrec`` phases' inputs (segments shared by the
    rows; ``segment_linear_scan`` on them zeroes ``a`` at each start).  The segmented
    scan's scale is the global ``Σ|x|`` prefix, ``analysis/ulp.py``'s contract for
    every method ("matmul" subtracts the scan before each segment start)."""
    rows, n = shape
    x = torch.randn(shape, generator=gen, device=DEV)
    xi = torch.randint(-3, 4, shape, generator=gen, device=DEV).float()
    off = seg_offsets(np.random.default_rng(SEG_SEED + 5), n)
    flags = boundary_flags(off, n)
    starts = flags > 0
    lin = lin_inputs(gen, shape)
    (a, b), (ai, bi) = lin["random"], lin["int"]
    cut = lambda t: torch.where(starts, 0.0, t)          # noqa: E731
    gscale = x.double().abs().cumsum(-1)
    return {
        "scan": (lambda **kw: scan(x, **kw), lambda **kw: scan(xi, **kw),
                 x.double().cumsum(-1), gscale, xi.double().cumsum(-1)),
        "segment_scan": (lambda **kw: segment_scan(x, off, **kw),
                         lambda **kw: segment_scan(xi, off, **kw), seg_ref64(x, flags)[0],
                         gscale, seg_ref64(xi, flags)[0]),
        "linear_scan": (lambda **kw: linear_scan(a, b, **kw),
                        lambda **kw: linear_scan(ai, bi, **kw), lin_ref64(a, b),
                        lin_ref64(a.abs(), b.abs()), lin_ref64(ai, bi)),
        "segment_linear_scan": (lambda **kw: segment_linear_scan(a, b, off, **kw),
                                lambda **kw: segment_linear_scan(ai, bi, off, **kw),
                                lin_ref64(cut(a), b), lin_ref64(cut(a).abs(), b.abs()),
                                lin_ref64(cut(ai), bi)),
    }


def _counted_call(fn, **kw):
    ops.reset_launch_counts()
    out = fn(**kw)
    sync()
    return out, ops.launch_counts()


def precision_kernels(gen) -> dict:
    """On "kernel" (B1, B9, B13) and "blocked" (B2-B4, B10-B12, B14-B16) at (4, 2^24):
    "compensated" and "fast" launch what "highest" launches and return its bits; each
    within ``ulp_bound(precision, n)`` of fp64; integer-valued rows exact.  Then
    ``ssd_scan`` on "kernel" at zamba2's shapes (1 B1 + 1 B13), the same bits."""
    n = SCAN_SHAPE[1]
    out = {}
    for op, (call, call_int, ref, scale, ref_int) in precision_inputs(gen, SCAN_SHAPE).items():
        for m in ("kernel", "blocked"):
            want, launches = _counted_call(call, method=m)
            row = {"launches": _nonzero(launches), "max_ulp": {}}
            for p in PRECISIONS:
                got, counts = _counted_call(call, method=m, precision=p)
                check(counts == launches, f"precision {op}/{m}/{p}: launches {counts} != "
                      f"highest's {launches}")
                check(torch.equal(got, want), f"precision {op}/{m}/{p}: not the bits of "
                      "highest")
                row["max_ulp"][p] = e = max_ulp_dev(got, ref, scale)
                check(e <= ulp.ulp_bound(p, n), f"precision {op}/{m}/{p}: {e} ulp > "
                      f"{ulp.ulp_bound(p, n)}")
                yi, counts = _counted_call(call_int, method=m, precision=p)
                check(counts == launches and torch.equal(yi.double(), ref_int),
                      f"precision {op}/{m}/{p}: integer-valued rows not exact")
            out[f"{op}/{m}"] = row
        del call, call_int, ref, scale, ref_int
    args = ssd_inputs(gen)
    want, launches = _counted_call(lambda **kw: ssd_scan(*args, chunk=SSD["chunk"], **kw),
                                   scan_method="kernel")
    expect_counts(launches, "ssd_scan(kernel)", scan_mm=1, linrec_scan=1)
    for p in PRECISIONS:
        got, counts = _counted_call(lambda **kw: ssd_scan(*args, chunk=SSD["chunk"], **kw),
                                    scan_method="kernel", precision=p)
        check(counts == launches and torch.equal(got, want),
              f"precision ssd_scan(kernel)/{p}: launches {counts} or bits differ")
    out["ssd_scan/kernel"] = {"launches": _nonzero(launches), "bits_equal": True}
    return out


def precision_matmul(gen) -> dict:
    """``"matmul"`` at (4, 2^20), where the split really runs: ``scan``,
    ``segment_scan`` and ``linear_scan`` within each precision's bound of fp64,
    integer-valued rows exact under "compensated", and eager ms of the three
    precisions taken in turns."""
    n = PRECISION_MATMUL_SHAPE[1]
    out = {}
    for op, (call, call_int, ref, scale, ref_int) in precision_inputs(
            gen, PRECISION_MATMUL_SHAPE).items():
        if op == "segment_linear_scan":
            continue
        row = {"max_ulp": {}, "ms": {p: [] for p in PRECISIONS}}
        for p in PRECISIONS:
            got, counts = _counted_call(call, method="matmul", precision=p)
            expect_counts(counts, f"{op}(matmul, {p})")
            row["max_ulp"][p] = e = max_ulp_dev(got, ref, scale)
            check(e <= ulp.ulp_bound(p, n), f"precision {op}/matmul/{p}: {e} ulp > "
                  f"{ulp.ulp_bound(p, n)}")
            if p == "highest":
                hi = got
            elif p == "fast":
                # bf16 operands move the result far beyond a reordering of fp32 sums
                row["fast_from_highest_ulp"] = e = max_ulp_dev(got, hi.double(), scale)
                check(e > 2 * ulp.ulp_bound("highest", n),
                      f"precision {op}/matmul/fast: only {e} ulp from highest")
            del got
        del hi
        yi = call_int(method="matmul", precision="compensated")
        check(torch.equal(yi.double(), ref_int),
              f"precision {op}/matmul/compensated: integer-valued rows not exact")
        del yi
        for turn in (PRECISIONS, PRECISIONS[::-1]):
            for p in turn:
                row["ms"][p].append(cuda_ms(lambda p=p: call(method="matmul", precision=p),
                                            PRECISION_REPS))
        row["ms"] = {p: sum(v) / len(v) for p, v in row["ms"].items()}
        row["ms_over_highest"] = {p: row["ms"][p] / row["ms"]["highest"] for p in PRECISIONS}
        out[op] = row
        del call, call_int, ref, scale, ref_int
        _free_card()
    return out


def precision_card_vs_cpu(gen) -> dict:
    """``"matmul"`` on the card against the port's ``"matmul"`` on the CPU (the plain
    products the CPU tests hold within twice ``"highest"``'s bound of JAX's) on the
    same inputs at ``PRECISION_CPU_SHAPE``, under every precision: ``scan`` and
    ``segment_scan`` within twice ``ulp_bound("highest", n)`` of each other, so the
    card's ``"fast"`` rounds to bf16 where the CPU does and its ``"compensated"``
    splits where the CPU does.  ``linear_scan``'s weights come from a ``cumprod``
    whose fp32 rounding differs by device (a third of them, run BC), and a rare
    weight then rounds to the other bf16 neighbour (7 of 524288), moving a few
    outputs by up to ~10^4 ulp: there the mean distance is held within
    ``ulp_bound("highest", 1)`` (8 ulp), where ``"fast"`` lies ~4·10^3 ulp from
    ``"highest"`` on average."""
    rows, n = shape = PRECISION_CPU_SHAPE
    x = torch.randn(shape, generator=gen, device=DEV)
    off = seg_offsets(np.random.default_rng(SEG_SEED + 6), n)
    a, b = lin_inputs(gen, shape)["random"]
    gscale = x.double().abs().cumsum(-1)
    ops_ = {"scan": (lambda x, off, a, b, **kw: scan(x, **kw), gscale),
            "segment_scan": (lambda x, off, a, b, **kw: segment_scan(x, off, **kw), gscale),
            "linear_scan": (lambda x, off, a, b, **kw: linear_scan(a, b, **kw),
                            lin_ref64(a.abs(), b.abs()))}
    limit, mean_limit = 2 * ulp.ulp_bound("highest", n), ulp.ulp_bound("highest", 1)
    out = {"shape": list(shape), "limit_ulp": limit, "mean_limit_ulp": mean_limit}
    for op, (fn, scale) in ops_.items():
        out[op] = {}
        for p in PRECISIONS:
            card = fn(x, off, a, b, method="matmul", precision=p)
            cpu = fn(x.cpu(), off.cpu(), a.cpu(), b.cpu(), method="matmul", precision=p)
            u = ulp_dev(card, cpu.to(DEV).double(), scale)
            out[op][p] = {"max_ulp": float(u.max()), "mean_ulp": float(u.mean())}
            check(float(u.mean()) <= mean_limit, f"precision {op}/matmul/{p}: card "
                  f"{float(u.mean())} ulp from the CPU on average > {mean_limit}")
            check(op == "linear_scan" or float(u.max()) <= limit,
                  f"precision {op}/matmul/{p}: card {float(u.max())} ulp from the CPU > "
                  f"{limit}")
    return out


def precision_split() -> dict:
    """``split_f16`` on the card against the CPU, bit for bit, on rows with a max
    near 2^±126, subnormal elements and maxima, values past fp16's range, zero rows,
    NaN and ±inf, along both axes; 22-bit mantissas come back exactly.  A NaN is
    NaN in the same place: its fp16 payload is the device's (the CPU's cast keeps
    the top payload bits, the card's gives 0x7FFF, run AZ)."""
    g = torch.Generator().manual_seed(SEG_SEED)
    mag = 0.5 + torch.randn((8, 1024), generator=g).abs()
    ints = torch.randint(-(1 << 21), 1 << 21, (4, 1024), generator=g).float()
    rows = torch.cat([mag * 2.0 ** 125, mag * 2.0 ** -125, mag * 2.0 ** -140,
                      mag * 2.0 ** -147, mag * 65504.0 * 3, torch.zeros((1, 1024)),
                      ints * 2.0 ** -20, ints * 2.0 ** -145])
    special = torch.ones((3, 1024))
    special[0, 3], special[1, 7], special[2, [1, 9]] = float("nan"), float("inf"), float("-inf")
    rows = torch.cat([rows, special])
    for axis in (-1, -2):
        cpu = split_f16(rows, axis=axis)
        card = split_f16(rows.to(DEV), axis=axis)
        for name, c, k in zip(("hi", "lo", "e"), cpu, card):
            k = k.cpu()
            view = torch.int16 if c.dtype == torch.float16 else c.dtype
            nan = torch.isnan(c) if c.is_floating_point() else torch.zeros_like(c, dtype=bool)
            check(torch.equal(nan, torch.isnan(k) if k.is_floating_point() else nan)
                  and torch.equal(c.view(view)[~nan], k.view(view)[~nan]),
                  f"split_f16 axis {axis}: {name} differs on the card")
    exact = torch.cat([ints * 2.0 ** -20, ints * 2.0 ** -145, ints * 2.0 ** -160]).to(DEV)
    hi, lo, e = split_f16(exact, axis=-1)
    shift = torch.tensor(-SPLIT_SHIFT, device=DEV)
    check(torch.equal(ldexp(hi.float() + ldexp(lo.float(), shift), e), exact),
          "split_f16 on the card: 22-bit mantissas not reconstructed exactly")
    tiny = torch.finfo(torch.float32).tiny
    subnormal_max = int((rows.abs().amax(-1) < tiny).sum()
                        + (exact.abs().amax(-1) < tiny).sum())
    return {"rows": rows.shape[0], "row_len": rows.shape[1], "axes": [-1, -2],
            "bit_equal_cpu": True, "exact_rows": exact.shape[0],
            "rows_with_subnormal_max": subnormal_max}


def precision_resolution(gen) -> dict:
    """The chain on ``method="auto"`` calls on the card: where the "cuda" table picks
    "vector" (scan fp32 at 4096) every precision gives ``torch.cumsum``'s bits; where
    it picks "kernel" (2^20) B1 launches once with "highest"'s bits; under
    ``method_override("matmul")`` the precision override and ``REPRO_SCAN_PRECISION``
    reach the call (the override winning) and give the explicit call's bits; an
    explicit ``method="vector", precision="fast"`` raises."""
    table = autotune.load_table()
    xv = torch.randn((4, PRECISION_AUTO["vector"]), generator=gen, device=DEV)
    xk = torch.randn((4, PRECISION_AUTO["kernel"]), generator=gen, device=DEV)
    for m, x in (("vector", xv), ("kernel", xk)):
        check(table_pick(table, "scan", x.shape[-1], "float32") == m,
              f"the cuda table no longer picks {m} for scan fp32 at {x.shape[-1]}")
    for p in PRECISIONS:
        got, counts = _counted_call(lambda **kw: scan(xv, **kw), precision=p)
        expect_counts(counts, f"scan auto->vector, {p}")
        check(torch.equal(got, torch.cumsum(xv, -1)), f"scan auto->vector, {p}: not cumsum")
        with precision_override(p):
            check(torch.equal(scan(xv), torch.cumsum(xv, -1)),
                  f"scan auto->vector under precision_override({p}): not cumsum")
    want, _ = _counted_call(lambda: scan(xk, method="kernel"))
    for p in PRECISIONS:
        got, counts = _counted_call(lambda **kw: scan(xk, **kw), precision=p)
        expect_counts(counts, f"scan auto->kernel, {p}", scan_mm=1)
        check(torch.equal(got, want), f"scan auto->kernel, {p}: not highest's bits")
    explicit = {p: scan(xk, method="matmul", precision=p) for p in PRECISIONS}
    check(not torch.equal(explicit["compensated"], explicit["highest"]),
          "scan(matmul): compensated gives highest's bits")
    seen = {}
    with method_override("matmul"):
        with precision_override("compensated"):
            seen["override"] = torch.equal(scan(xk), explicit["compensated"])
        os.environ[PRECISION_ENV] = "fast"
        try:
            seen["env"] = torch.equal(scan(xk), explicit["fast"])
            with precision_override("compensated"):
                seen["override_over_env"] = torch.equal(scan(xk), explicit["compensated"])
        finally:
            del os.environ[PRECISION_ENV]
    check(all(seen.values()), f"the precision chain on an auto call: {seen}")
    try:
        scan(xv, method="vector", precision="fast")
        refused = False
    except ValueError:
        refused = True
    check(refused, "scan(method='vector', precision='fast') did not raise")
    return {"auto_vector_n": xv.shape[-1], "auto_kernel_n": xk.shape[-1], **seen,
            "explicit_vector_fast_raises": refused}


def phase_precision(smi: str) -> dict:
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(PRECISION_SEED)
    res = {"card": smi, "kernels": precision_kernels(gen)}
    _free_card()
    res["matmul"] = precision_matmul(gen)
    res["matmul_card_vs_cpu"] = precision_card_vs_cpu(gen)
    res["split_f16"] = precision_split()
    res["resolution"] = precision_resolution(gen)
    emit({"phase": "precision", "shape": list(SCAN_SHAPE),
          "matmul_shape": list(PRECISION_MATMUL_SHAPE), **res,
          "seconds": time.perf_counter() - t0})
    return res


def alloc_launches(eng) -> dict:
    """The launches of one page allocation of ``eng``: a ``compress`` over the page
    ids on the method its ``alloc_method`` resolves to (counted here, outside any
    checked run)."""
    a = eng.alloc
    ops.reset_launch_counts()
    compress(a._ids, torch.ones_like(a._ids, dtype=torch.bool), method=a.method)
    sync()
    return ops.launch_counts()


def ssd_inputs(gen, dtype=torch.float32):
    """zamba2's SSD operands: x ~ N(0, 1), log decays -|0.01 g| (a chunk of 128 decays
    by ~e^-1, so the cross-chunk states matter), B and C scaled by 0.3."""
    b, s, h, p, n = (SSD[k] for k in ("batch", "seq", "heads", "head_dim", "state"))
    return (torch.randn((b, s, h, p), generator=gen, device=DEV, dtype=dtype),
            -(torch.randn((b, s, h), generator=gen, device=DEV, dtype=dtype) * 0.01).abs(),
            torch.randn((b, s, h, n), generator=gen, device=DEV, dtype=dtype) * 0.3,
            torch.randn((b, s, h, n), generator=gen, device=DEV, dtype=dtype) * 0.3)


def phase_ssd(gen):
    """``ssd_scan`` at zamba2's shapes on each method: "kernel" launches one B1 and one
    B13, "blocked" one B4 and one B16; both within ``SSD_REL``·max|y| of "vector" on
    the card, and every method within the JAX package's 2e-3 of the fp64 oracle."""
    args = ssd_inputs(gen)
    ref, ref_state = ssd_scan_ref(*(t.double() for t in args), return_final_state=True)
    out, runs = {}, {}
    for method, want in (("vector", {}),
                         ("kernel", {"scan_mm": 1, "linrec_scan": 1}),
                         ("blocked", {"block_scan": 1, "linrec_block_scan": 1})):
        ops.reset_launch_counts()
        y, state = ssd_scan(*args, chunk=SSD["chunk"], scan_method=method,
                            return_final_state=True)
        sync()
        runs[method] = ops.launch_counts()
        expect_counts(runs[method], f"ssd_scan({method})", **want)
        err = float(((y.double() - ref).abs() - 2e-3 * ref.abs()).max())
        serr = float(((state.double() - ref_state).abs() - 2e-3 * ref_state.abs()).max())
        check(bool(y.isfinite().all()) and err <= 2e-3 and serr <= 2e-3,
              f"ssd_scan({method}): outside 2e-3 of the fp64 oracle ({err}, {serr})")
        out[method] = (y, state)
    ymax = float(out["vector"][0].abs().max())
    res = {"max_abs_y": ymax, "launches": runs}
    for method in ("kernel", "blocked"):
        d = float((out[method][0] - out["vector"][0]).abs().max())
        ds = float((out[method][1] - out["vector"][1]).abs().max())
        res[f"{method}_max_abs_diff_vs_vector"] = d
        res[f"{method}_state_max_abs_diff_vs_vector"] = ds
        check(d <= SSD_REL * ymax, f"ssd_scan({method}) differs from vector by {d} > "
              f"{SSD_REL} * {ymax}")
    for method, (y, _) in out.items():
        res[f"{method}_max_abs_err_vs_fp64"] = float((y.double() - ref).abs().max())
        res[f"{method}_ms"] = cuda_ms(lambda m=method: ssd_scan(
            *args, chunk=SSD["chunk"], scan_method=m), 3)
    res["zamba2_decays"] = ssd_strong_decays(gen)
    emit({"phase": "ssd", **SSD, "limit_rel_to_max_y": SSD_REL, **res})
    return {k: runs["kernel"][k] + runs["blocked"][k] for k in ops.KERNELS}


def zamba2_decay_inputs(gen):
    """``ssd_inputs`` with the log decays of zamba2's init in place of ``-|0.01 g|``:
    ``-exp(A_log)·softplus(dt)`` with ``A_log = log(linspace(1, 16, H))``."""
    x, _, bm, cm = ssd_inputs(gen)
    dt = torch.nn.functional.softplus(torch.randn(x.shape[:3], generator=gen, device=DEV))
    return x, -torch.linspace(1.0, 16.0, x.shape[2], device=DEV) * dt, bm, cm


def ssd_strong_decays(gen):
    """The same shapes with the decays of zamba2's init (``-exp(A_log)·softplus(dt)``,
    ``A_log = log(linspace(1, 16, H))``): the log-decay cumsum of a chunk reaches
    ~10^3, so the methods' cumsum orders differ by ulps of that, which ``exp(cs_i -
    cs_j)`` carries into the output.  Every method within 2e-3 of the fp64 oracle;
    the distance between methods is reported."""
    x, al, bm, cm = zamba2_decay_inputs(gen)
    ref = ssd_scan_ref(x.double(), al.double(), bm.double(), cm.double())
    ys, res = {}, {"max_abs_log_decay_cumsum_per_chunk": float(
        al.reshape(al.shape[0], -1, SSD["chunk"], al.shape[2]).sum(2).abs().max())}
    for method in ("vector", "kernel", "blocked"):
        ys[method] = ssd_scan(x, al, bm, cm, chunk=SSD["chunk"], scan_method=method)
        err = float(((ys[method].double() - ref).abs() - 2e-3 * ref.abs()).max())
        check(bool(ys[method].isfinite().all()) and err <= 2e-3,
              f"ssd_scan({method}) with zamba2's decays: outside 2e-3 of the fp64 oracle")
        res[f"{method}_max_abs_err_vs_fp64"] = float((ys[method].double() - ref).abs().max())
    res["max_abs_y"] = float(ys["vector"].abs().max())
    for method in ("kernel", "blocked"):
        res[f"{method}_max_abs_diff_vs_vector"] = float((ys[method] - ys["vector"]).abs().max())
    return res


def serve_zamba2(gen):
    """zamba2-1.2b at full width and depth, bf16 weights from seed 0: ServeEngine with
    ``topp_kernel`` on injected uniforms under ``scan_method="kernel"`` (B1 + B13 once
    per Mamba2 layer in prefill) and ``"blocked"`` (B4 + B16), exact launch counts,
    no linear-recurrence launch in decode, every token held to its window."""
    cfg = get_config("zamba2-1.2b")
    b, s, new = ZAMBA["batch"], ZAMBA["prompt"], ZAMBA["new"]
    t0 = time.perf_counter()
    params = build_model(cfg).init(ZAMBA["seed"], device=DEV, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV)}
    uniforms = torch.rand((new, b), generator=gen, device=DEV)
    layers = cfg.n_layers
    sampler = {"radix_pass": 4 * new, "topp_tail": new}
    torch.cuda.reset_peak_memory_stats(DEV)
    out, counts, engines = {}, {}, {}
    for method, want in (("kernel", {"scan_mm": layers, "linrec_scan": layers}),
                         ("blocked", {"block_scan": layers, "linrec_block_scan": layers})):
        eng = ServeEngine(cfg, params, max_len=s + new, sampler="topp_kernel",
                          scan_method=method)
        eng.generate(batch, 2, uniforms=uniforms[:2])                      # warm-up
        ops.reset_launch_counts()
        toks, t_full = _timed_generate(eng, batch, new, uniforms=uniforms)
        counts[method] = ops.launch_counts()
        expect_counts(counts[method], f"zamba2 serving under scan_method={method!r}",
                      **want, **sampler)
        check(tuple(toks.shape) == (b, new) and toks.dtype == torch.int32
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"zamba2 {method}: tokens of shape {tuple(toks.shape)} or out of range")
        ops.reset_launch_counts()
        _, t_one = _timed_generate(eng, batch, 1, uniforms=uniforms[:1])
        expect_counts(ops.launch_counts(), f"zamba2 {method}: prefill and one sample",
                      **want, radix_pass=4, topp_tail=1)
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            eng.model.prefill(params, batch, cache_len=s + new)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        decode_ms = (t_full - t_one) / (new - 1) * 1e3
        sampled = check_sampled(eng, batch, uniforms, toks, new)
        out[method] = {"launches": counts[method], "prefill_ms": prefill_ms,
                       "prefill_plus_first_sample_ms": t_one * 1e3,
                       "decode_step_ms": decode_ms, "tokens_per_s": b * new / t_full,
                       "generate_s": t_full, **sampled}
        engines[method] = eng
    peak_gb = torch.cuda.max_memory_allocated(DEV) / 1e9
    busy = decode_busy(engines["kernel"], params, batch, uniforms, s, new)
    out["kernel"]["profiled_decode"] = busy
    out["kernel"]["device_idle_share"] = (
        None if busy["device_busy_ms_per_step"] is None
        else 1.0 - busy["device_busy_ms_per_step"] / out["kernel"]["decode_step_ms"])
    greedy, logits = {}, {}
    for method in ("vector", "kernel", "blocked"):
        e2 = ServeEngine(cfg, params, max_len=s + new, sampler="greedy", scan_method=method)
        greedy[method] = e2.generate(batch, new)
        with torch.inference_mode():
            logits[method] = e2.model.prefill(params, batch, cache_len=s + new)[0]
    agree = {m: int((greedy[m] == greedy["vector"]).sum()) for m in ("kernel", "blocked")}
    # how far apart the bf16 runs are, against how close the vector run's top two are
    top2 = torch.topk(logits["vector"], 2, dim=-1).values
    prefill_logits = {
        "vector_top2_margin": (top2[:, 0] - top2[:, 1]).tolist(),
        **{f"{m}_max_abs_diff_vs_vector": float((logits[m] - logits["vector"]).abs().max())
           for m in ("kernel", "blocked")},
        **{f"{m}_first_token_equal": int((greedy[m][:, 0] == greedy["vector"][:, 0]).sum())
           for m in ("kernel", "blocked")}}
    emit({"phase": "serve_zamba2", "arch": cfg.name, "n_layers": layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
          "dtype": "bfloat16", "batch": b, "prompt": s, "new_tokens": new, "init_s": init_s,
          "peak_mem_gb": peak_gb, **out,
          "greedy_tokens_equal_to_vector": agree, "greedy_tokens": b * new,
          "prefill_logits": prefill_logits})
    return {k: counts["kernel"][k] + counts["blocked"][k] for k in ops.KERNELS}


def _timed_generate(eng, batch, new, **kw):
    sync()
    t0 = time.perf_counter()
    toks = eng.generate(batch, new, **kw)
    sync()
    return toks, time.perf_counter() - t0


def smoke_reference(gen):
    """The SMOKE model on the card against the same weights on the CPU (plain path)."""
    cfg = get_config("llama3-8b", smoke=True)
    params_cpu = build_model(cfg).init(1, device="cpu")
    params_gpu = _to(params_cpu, DEV)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))
    model = build_model(cfg)
    lc, _ = model.prefill(params_cpu, {"tokens": toks}, cache_len=24)
    lg, _ = model.prefill(params_gpu, {"tokens": toks.to(DEV)}, cache_len=24)
    err = float((lg.cpu() - lc).abs().max())
    check(err < 1e-4, f"SMOKE prefill logits on the card differ from the CPU by {err}")
    u = torch.rand((6, 2), generator=torch.Generator().manual_seed(3))
    out = {}
    for sampler in ("greedy", "topp_kernel"):
        tc = ServeEngine(cfg, params_cpu, max_len=24, sampler=sampler, device="cpu")
        tg = ServeEngine(cfg, params_gpu, max_len=24, sampler=sampler, device=DEV)
        a = tc.generate({"tokens": toks}, 6, uniforms=u)
        b = tg.generate({"tokens": toks}, 6, uniforms=u).cpu()
        out[sampler] = float((a == b).float().mean())
    check(out["greedy"] == 1.0, "SMOKE greedy tokens on the card differ from the CPU")
    return {"smoke_logits_max_abs_err": err, "smoke_token_agreement": out}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_sampled(eng, batch, uniforms, toks, new):
    """Rerun ``eng`` on the same batch and uniforms, recording each step, and hold
    every sampled token to its row's ``topp_window`` (:func:`hold_steps`)."""
    steps = []
    orig = eng._sample

    def recording(logits, generator, u):
        tok = orig(logits, generator, u)
        steps.append((logits.clone(), u.clone(), tok.clone()))
        return tok

    eng._sample = recording
    toks2 = eng.generate(batch, new, uniforms=uniforms)
    eng._sample = orig
    check(torch.equal(toks2, toks), f"the {eng.sampler} run is not repeatable")
    return hold_steps(steps, eng.top_p, eng.sampler)


def hold_steps(steps, top_p, name, masks: bool = False):
    """Hold each ``(logits, u, tok)`` step's tokens to the ``topp_window`` of their
    rows: inside it on every row, and equal to the plain sampler's token where the
    window has one index.  With ``masks``, ``-inf`` logits (vocabulary masks) are
    allowed; NaN and ``+inf`` never are."""
    agree = total = one_answer = plain_in = widest = 0
    for logits, u, tok in steps:
        bad = (logits.isnan() | logits.isposinf()) if masks else ~logits.isfinite()
        check(not bool(bad.any()), f"{name}: non-finite logits on the sampled rows")
        plain = top_p_sample(logits, p=top_p, method="vector", u=u)
        probs = torch.softmax(logits.float(), -1)
        _, order = radix_sort(probs.to(torch.bfloat16), descending=True, method="vector")
        sp = torch.gather(probs, -1, order.long())
        _, lo, hi = topp_window(sp, u, top_p)
        # the sampled token's place in the sorted order
        jk = (order == tok[:, None]).int().argmax(-1).cpu().numpy()
        jp = (order == plain[:, None]).int().argmax(-1).cpu().numpy()
        check(((lo <= jk) & (jk <= hi)).all(),
              f"{name} token outside the band's window: {jk.tolist()} not in "
              f"{lo.tolist()}..{hi.tolist()}")
        same = (tok == plain).cpu().numpy()
        check(same[lo == hi].all(), f"{name} != plain sampler on a row outside the band")
        agree += int(same.sum())
        total += same.size
        one_answer += int((lo == hi).sum())
        plain_in += int(((lo <= jp) & (jp <= hi)).sum())
        widest = max(widest, int((hi - lo).max()))
    return {"steps_checked": len(steps), "token_agreement_with_plain_sampler": agree / total,
            "rows_with_one_answer": one_answer, "widest_window": widest,
            "plain_sampler_rows_in_window": plain_in}


def blocked_scans_per_token(eng) -> int:
    """B4 launches per sampled token of ``topp_blocked``: one batched mask scan per
    radix pass over the 16-bit keys, the tail's prefix sum, and the CDF of
    ``weighted_sample``.  A llama3 row is one block, so B2 and B3 launch 0 times."""
    return -(-16 // eng.bits_per_pass) + 2


def segmented_scans_per_token(eng) -> int:
    """Segmented scans per sampled token of ``topp_segmented``: the softmax's
    normaliser, one batched one-hot scan per radix pass over the 16-bit keys, the
    prefix sum of the sorted probabilities, the CDF and the count below ``theta``."""
    return 1 + -(-16 // eng.bits_per_pass) + 3


def seg_counts(method: str, n: int, scans: int) -> dict:
    """The launches of ``scans`` segmented scans of a packed row of ``n`` on ``method``
    at the default geometry: B9 once each, or B12 once each and B10, B11 too when
    the row has more than one block."""
    if method == "kernel":
        return {"seg_scan": scans}
    two = scans if scan_pipeline.block_geometry(n, 128, 8)[2] > 1 else 0
    return {"seg_summaries": two, "seg_carry": two, "seg_block_scan": scans}


def serve_segmented(eng_k, cfg, params, batch, uniforms, s, new):
    """``topp_segmented`` under ``method_override("kernel")`` and ``("blocked")`` on
    the same weights and uniforms, with exact launch counts and every token held to
    its window; then ``sample_packed`` on ragged logit rows under each override."""
    eng = ServeEngine(cfg, params, max_len=s + new, sampler="topp_segmented")
    per_token = segmented_scans_per_token(eng)
    b = batch["tokens"].shape[0]
    out, counts = {}, {}
    for method in ("kernel", "blocked"):
        with method_override(method):
            eng.generate(batch, 2, uniforms=uniforms[:2])                  # warm-up
            ops.reset_launch_counts()
            toks, t_full = _timed_generate(eng, batch, new, uniforms=uniforms)
            counts[method] = ops.launch_counts()
            expect_counts(counts[method], f"topp_segmented serving under {method}",
                          **seg_counts(method, b * cfg.padded_vocab, per_token * new))
            check(tuple(toks.shape) == (b, new) and toks.dtype == torch.int32,
                  f"topp_segmented tokens have shape {tuple(toks.shape)}")
            _, t_one = _timed_generate(eng, batch, 1, uniforms=uniforms[:1])
            sampled = check_sampled(eng, batch, uniforms, toks, new)
        out[method] = {"launches": counts[method], "tokens_per_s": b * new / t_full,
                       "decode_step_ms": (t_full - t_one) / (new - 1) * 1e3, **sampled,
                       "stream": toks}
    for method in ("kernel", "blocked"):
        out[method]["stream_agreement_with_topp_kernel"] = float(
            (out[method].pop("stream") == eng_k).float().mean())
    packed, packed_counts = sample_packed_check(eng, params, batch, uniforms, s, new)
    emit({"phase": "main_serve_topp_segmented", "segmented_scans_per_token": per_token,
          "packed_n": b * cfg.padded_vocab, **out, "sample_packed": packed})
    return {k: counts["kernel"][k] + counts["blocked"][k] + packed_counts[k]
            for k in ops.KERNELS}


def sample_packed_check(eng, params, batch, uniforms, s, new):
    """``sample_packed`` on ragged rows of the prefill's logits (``PACKED_ROWS`` long,
    one empty) under each override: exact launch counts, and each segment's token
    inside its window and equal to the port's 1-D ``top_p_sample`` of the row where
    the window has one index."""
    logits, _ = eng.model.prefill(params, batch, cache_len=s + new)
    segs = [logits[i % logits.shape[0], :ln].float() for i, ln in enumerate(PACKED_ROWS)]
    off = torch.tensor(np.concatenate([[0], np.cumsum(PACKED_ROWS)]), dtype=torch.int32,
                       device=DEV)
    packed = SegmentedBatch(torch.cat(segs), off)
    u = uniforms[0][:len(PACKED_ROWS), None]
    res, total = {}, {k: 0 for k in ops.KERNELS}
    for method in ("kernel", "blocked"):
        with method_override(method):
            ops.reset_launch_counts()
            tok = eng.sample_packed(packed, u=u)
            sync()
            counts = ops.launch_counts()
        expect_counts(counts, f"sample_packed under {method}",
                      **seg_counts(method, int(off[-1]), segmented_scans_per_token(eng)))
        total = {k: total[k] + counts[k] for k in ops.KERNELS}
        rows = []
        for i, seg in enumerate(segs):
            if seg.numel() == 0:
                check(int(tok[i]) == 0, "sample_packed: an empty row sampled a token")
                continue
            one = top_p_sample(seg[None], p=eng.top_p, method="vector", u=u[i:i + 1])
            probs = torch.softmax(seg, -1)
            _, order = radix_sort(probs.to(torch.bfloat16), descending=True, method="vector")
            _, lo, hi = topp_window(probs[order.long()][None], u[i:i + 1], eng.top_p)
            jk = int((order == tok[i]).int().argmax())
            check(lo[0] <= jk <= hi[0], f"sample_packed row {i} under {method}: position "
                  f"{jk} outside the window {lo[0]}..{hi[0]}")
            check(lo[0] < hi[0] or int(tok[i]) == int(one[0]),
                  f"sample_packed row {i} under {method}: != top_p_sample outside the band")
            rows.append({"row": i, "n": seg.numel(), "token": int(tok[i]),
                         "top_p_sample_token": int(one[0]), "window": [int(lo[0]),
                                                                        int(hi[0])]})
        res[method] = {"launches": counts, "rows": rows}
    return res, total


def main_serve(gen):
    cfg = get_config("llama3-8b")
    b, s, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    params = build_model(cfg).init(SERVE["seed"], device=DEV, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV)
    batch = {"tokens": prompts}
    uniforms = torch.rand((new, b), generator=gen, device=DEV)
    eng = ServeEngine(cfg, params, max_len=s + new, sampler="topp_kernel")
    eng.generate(batch, 2, uniforms=uniforms[:2])                  # warm-up
    # --- the main path: counters zeroed just before, read just after ---
    ops.reset_launch_counts()
    toks, t_full = _timed_generate(eng, batch, new, uniforms=uniforms)
    counts = ops.launch_counts()
    check(tuple(toks.shape) == (b, new) and toks.dtype == torch.int32,
          f"topp_kernel tokens have shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token ids out of range")
    check(counts["radix_pass"] == 4 * new and counts["topp_tail"] == new,
          f"expected {4 * new} B7 and {new} B8 launches for {new} sampled steps, got {counts}")
    _, t_one = _timed_generate(eng, batch, 1, uniforms=uniforms[:1])
    decode_ms = (t_full - t_one) / (new - 1) * 1e3
    # --- the same run, each step's sample checked against the plain sampler ---
    sampled = check_sampled(eng, batch, uniforms, toks, new)
    # --- this slice's path: the same weights and uniforms through topp_blocked ---
    eng_b = ServeEngine(cfg, params, max_len=s + new, sampler="topp_blocked")
    eng_b.generate(batch, 2, uniforms=uniforms[:2])                # warm-up
    ops.reset_launch_counts()
    toks_b, t_b = _timed_generate(eng_b, batch, new, uniforms=uniforms)
    counts_b = ops.launch_counts()
    expect_counts(counts_b, "topp_blocked serving",
                  block_scan=blocked_scans_per_token(eng_b) * new)
    check(tuple(toks_b.shape) == (b, new) and toks_b.dtype == torch.int32,
          f"topp_blocked tokens have shape {tuple(toks_b.shape)}")
    _, t_one_b = _timed_generate(eng_b, batch, 1, uniforms=uniforms[:1])
    sampled_b = check_sampled(eng_b, batch, uniforms, toks_b, new)
    # --- greedy and the plain-path sampler over the same weights and uniforms ---
    runs = {"topp_kernel": t_full, "topp_blocked": t_b}
    for sampler in ("greedy", "topp_scan"):
        e2 = ServeEngine(cfg, params, max_len=s + new, sampler=sampler)
        e2.generate(batch, 2, uniforms=uniforms[:2])
        t2 = _timed_generate(e2, batch, new, uniforms=uniforms)
        runs[sampler] = t2[1]
        if sampler == "topp_scan":
            scan_agree = float((t2[0] == toks).float().mean())
            scan_agree_b = float((t2[0] == toks_b).float().mean())
    # --- this slice's path: the same weights and uniforms through topp_segmented ---
    counts_s = serve_segmented(toks, cfg, params, batch, uniforms, s, new)
    peak_gb = torch.cuda.max_memory_allocated(DEV) / 1e9
    busy = decode_busy(eng, params, batch, uniforms, s, new)
    emit({"phase": "main_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
          "dtype": "bfloat16", "batch": b, "prompt": s, "new_tokens": new,
          "init_s": init_s, "launches": counts,
          "tokens_per_s": {k: b * new / v for k, v in runs.items()},
          "generate_s": runs, "prefill_plus_first_sample_ms": t_one * 1e3,
          "decode_step_ms": decode_ms, "peak_mem_gb": peak_gb, **sampled,
          "stream_agreement_with_topp_scan": scan_agree,
          "profiled_decode": busy,
          "device_idle_share": (None if busy["device_busy_ms_per_step"] is None
                                else 1.0 - busy["device_busy_ms_per_step"] / decode_ms)})
    emit({"phase": "main_serve_topp_blocked", "launches": counts_b,
          "blocked_scans_per_token": blocked_scans_per_token(eng_b),
          "decode_step_ms": (t_b - t_one_b) / (new - 1) * 1e3,
          "prefill_plus_first_sample_ms": t_one_b * 1e3, **sampled_b,
          "stream_agreement_with_topp_kernel": float((toks_b == toks).float().mean()),
          "stream_agreement_with_topp_scan": scan_agree_b})
    return counts, counts_b, counts_s, params


@torch.inference_mode()
def decode_busy(eng, params, batch, uniforms, s, new, steps: int = 4):
    """Device time and device operations per decode step (model + sampler), from
    a ``torch.profiler`` trace of ``steps`` steps; ``None`` if it records no device work."""
    logits, caches = eng.model.prefill(params, batch, cache_len=s + new)
    tok = eng._sample(logits, None, uniforms[0][:, None])
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, caches = eng.model.decode_step(params, tok[:, None], caches, s + i)
            tok = eng._sample(logits, None, uniforms[i + 1][:, None])
        sync()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    return {"steps": steps, "device_ops_per_step": len(dev) / steps,
            "device_busy_ms_per_step": busy_ms if dev else None,
            "profiled_wall_ms_per_step": wall / steps * 1e3}


# ---------------------------------------------------------------------------
# serve_continuous: continuous batching over the paged KV cache
# ---------------------------------------------------------------------------


class TickProbe:
    """Wraps a ContinuousEngine's ``_decode_n`` (one tick): the wall ms of each tick
    and, while ``count`` is set, its host syncs (``torch.cuda.set_sync_debug_mode``
    warnings, the tick itself timed inside that mode); tick ``profile`` (0-based,
    counted while ``count`` is set) runs under ``torch.profiler`` and gives the
    device's busy ms against the tick's wall ms."""

    def __init__(self, eng, profile: int):
        self.orig, self.profile = eng._decode_n, profile
        eng._decode_n = self
        self.count, self.ms, self.steps, self.syncs, self.busy = True, [], [], [], None
        self.sites = collections.Counter()

    def __call__(self, n_steps):
        if not self.count:
            t0 = time.perf_counter()
            out = self.orig(n_steps)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.steps.append(out[1])
            return out
        sync()
        if len(self.syncs) == self.profile and self.busy is None:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = self.orig(n_steps)
                wall = (time.perf_counter() - t0) * 1e3
            dev = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 if dev else None
            self.busy = {"tick": self.profile, "wall_ms": wall, "device_busy_ms": busy,
                         "device_ops": len(dev),
                         "device_idle_share": None if busy is None else 1 - busy / wall}
            return out
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                out = self.orig(n_steps)
                self.ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in caught if "synchroniz" in str(w.message)]
        self.syncs.append(len(hits))
        self.sites.update(f"{os.path.basename(w.filename)}:{w.lineno}" for w in hits)
        return out


def _same_run(a, b) -> bool:
    return (a["requests"] == b["requests"] and a["stats"] == b["stats"]
            and a["streams"].keys() == b["streams"].keys()
            and all(np.array_equal(a["streams"][k], b["streams"][k]) for k in a["streams"]))


def continuous_layout_parity(eng, req) -> dict:
    """One request's prefill inserted into a row of the engine's full-width pages:
    ``gather_dense`` of the row equals the dense prefill cache bit for bit."""
    m = paged_kv.pages_needed(req.tokens.size + req.max_new_tokens, eng.page_size)
    pages = eng.alloc.alloc(m)
    toks = torch.as_tensor(req.tokens, device=DEV)[None]
    _, dense = eng.model.prefill(eng.params, {"tokens": toks}, cache_len=m * eng.page_size)
    paged_kv.insert_request(eng.caches, dense, 0, pages)
    view = paged_kv.gather_dense(eng.caches)["stack"]["sub0"]
    equal = all(torch.equal(view[n][:, 0, :m * eng.page_size], dense["stack"]["sub0"][n][:, 0])
                for n in ("k", "v"))
    check(equal, "serve_continuous: the gathered pages differ from the dense prefill cache")
    eng.alloc.release(pages)
    paged_kv.clear_page_table(eng.caches, 0)
    return {"pages": m, "positions": m * eng.page_size, "bit_equal": equal}


@torch.inference_mode()
def batch_logit_gap(model, params, reqs, clen: int, steps: int = 4) -> dict:
    """Decode steps of ``len(reqs)`` rows at once (per-row positions) and of each row
    alone, fed the same tokens: whether the logits agree bit for bit, and their
    largest difference, the ``delta`` of the divergence rule."""
    singles = [model.prefill(params, {"tokens": torch.as_tensor(r.tokens, device=DEV)[None]},
                             cache_len=clen) for r in reqs]
    batched = {"stack": {"sub0": {n: torch.cat([c["stack"]["sub0"][n] for _, c in singles], 1)
                                  for n in ("k", "v")}}}
    tok = torch.cat([torch.argmax(lg, -1) for lg, _ in singles]).to(torch.int32)
    pos = torch.tensor([r.tokens.size for r in reqs], device=DEV)
    gap, same = 0.0, True
    for _ in range(steps):
        lb, batched = model.decode_step(params, tok[:, None], batched, pos)
        ls = torch.cat([model.decode_step(params, tok[r:r + 1, None], singles[r][1],
                                          int(pos[r]))[0] for r in range(len(reqs))])
        same &= torch.equal(lb, ls)
        gap = max(gap, float((lb - ls).abs().max()))
        tok = torch.argmax(lb, -1).to(torch.int32)
        pos = pos + 1
    return {"rows": len(reqs), "steps": steps, "bit_equal": same, "max_abs_logit_diff": gap}


def solo_streams(cfg, params, trace, sampler: str, n_ctx: int, cont, gap: float) -> dict:
    """Each request alone through ``ServeEngine.generate`` (the dense sequential
    baseline, timed) with the request's uniform stream, each stream held to the
    continuous one: equal, or parting first at a step whose ``step_margin`` lies
    within ``gap`` (where the batch-1 and batch-8 bits agree, equal everywhere)."""
    solo = ServeEngine(cfg, params, max_len=n_ctx, sampler=sampler)
    orig = solo._sample
    logits = []
    solo._sample = lambda lg, g, u: (logits.append(lg[0].clone()), orig(lg, g, u))[1]
    equal, parted, total, wall = 0, [], 0, 0.0
    for r in trace:
        logits.clear()
        u = torch.rand((r.max_new_tokens,), generator=torch.Generator(device=DEV).manual_seed(
            r.seed), device=DEV)
        prompt = {"tokens": torch.as_tensor(r.tokens, device=DEV)[None]}
        ref, dt = _timed_generate(solo, prompt, r.max_new_tokens, uniforms=u[:, None])
        wall += dt
        ref = ref[0].cpu().numpy()
        total += ref.size
        got = cont["streams"][r.rid]
        k = first_divergence(got, ref)
        if k is None:
            equal += 1
            continue
        check(gap > 0 and k < min(got.size, ref.size),
              f"serve_continuous {sampler}: {r.rid} left its solo stream at step {k} "
              "though batch 1 and batch 8 give a row the same bits")
        margin = step_margin(logits[k], float(u[k]), sampler=sampler, top_p=solo.top_p,
                             other=int(got[k]))
        check(margin <= gap, f"serve_continuous {sampler}: {r.rid} left its solo stream at "
              f"step {k}, whose margin {margin} exceeds the measured logit difference {gap}")
        parted.append({"rid": r.rid, "step": k, "of": int(ref.size), "margin": margin})
    return {"streams_equal": equal, "streams": len(trace), "first_divergences": parted,
            "tokens": total, "seconds": wall, "tokens_per_s": total / wall}


def serve_continuous(params) -> dict:
    """ContinuousEngine on llama3-8b at full width under the Poisson trace: the
    layout, schedule, replay, solo-stream and launch checks, the warm-up run's
    paged decode held bit for bit to a dense replay of its steps, and each
    sampler's times beside the dense sequential baseline.  Returns the timed
    runs' launches."""
    t_phase = time.perf_counter()
    cfg = get_config("llama3-8b")
    trace = poisson_trace(vocab_size=cfg.vocab_size, **CONT_TRACE)
    parts = {}

    def lap(name, since):
        parts[name] = time.perf_counter() - since
        return time.perf_counter()

    t = time.perf_counter()
    # the schedule of the same trace and geometry: the SMOKE model on the CPU
    scfg = get_config("llama3-8b", smoke=True)
    cpu = ContinuousEngine(scfg, build_model(scfg).init(0, device="cpu"), device="cpu",
                           **CONTINUOUS).run(
        [dataclasses.replace(r, tokens=r.tokens % scfg.vocab_size) for r in trace])
    engines = {s: ContinuousEngine(cfg, params, sampler=s, alloc_method=(
        "kernel" if s == CONT_KERNEL_ALLOC else "auto"), **CONTINUOUS) for s in CONT_SAMPLERS}
    eng0 = engines[CONT_SAMPLERS[0]]
    n_ctx = eng0.n_blocks * eng0.page_size
    t = lap("cpu_schedule", t)
    parity = continuous_layout_parity(eng0, trace[0])
    gap = batch_logit_gap(eng0.model, params, trace[:eng0.max_batch], n_ctx)
    t = lap("parity_and_batch_gap", t)
    # one allocation's launches: none on "matmul"/"vector", B5 on "kernel" (the
    # topp_scan run's allocator), B2-B4 on "blocked"; "auto" resolves at n_pages
    per_alloc = {s: alloc_launches(e) for s, e in engines.items()}
    out, launches = {}, {k: 0 for k in ops.KERNELS}
    for sampler, eng in engines.items():
        probe = TickProbe(eng, profile=CONT_PROFILE_TICK)
        with DenseReplay(eng) as rep:                               # warm-up
            first = eng.run(trace)
        replay = rep.result()
        check(replay["bit_equal"] and replay["row_steps"] > 0
              and replay["steps"] == eng.tick_tokens * (len(probe.syncs)
                                                         + (probe.busy is not None)),
              f"serve_continuous {sampler}: paged decode differs from the dense replay "
              f"of its steps: {replay}")
        probe.count, probe.ms = False, []
        t = lap(f"{sampler}_warm_up", t)
        # --- the main path: counters zeroed just before, read just after ---
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        res = eng.run(trace)
        sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        calls = eng.alloc.calls
        expect_counts(counts, f"serve_continuous {sampler}",
                      **{k: v * calls for k, v in per_alloc[sampler].items()})
        launches = {k: launches[k] + counts[k] for k in ops.KERNELS}
        check(_same_run(first, res),
              f"serve_continuous {sampler}: two runs of the trace differ")
        check(res["requests"] == cpu["requests"] and res["stats"] == cpu["stats"],
              f"serve_continuous {sampler}: the schedule differs from the CPU's SMOKE run")
        check(all(s.size == r.max_new_tokens and ((s >= 0) & (s < cfg.vocab_size)).all()
                  for r in trace for s in [res["streams"][r.rid]]),
              f"serve_continuous {sampler}: a stream of the wrong length or out of range")
        st = res["stats"]
        lat = [q["per_token_latency_steps"] for q in res["requests"].values()]
        t = lap(f"{sampler}_timed", t)
        solo = solo_streams(cfg, params, trace, sampler, n_ctx, res,
                            gap["max_abs_logit_diff"])
        t = lap(f"{sampler}_solo", t)
        out[sampler] = {
            "alloc_method": eng.alloc_method, "alloc_launches": {
                k: v for k, v in per_alloc[sampler].items() if v}, "launches": counts,
            "alloc_calls": calls, "admissions": len(trace), "alloc_refused": eng.alloc.refused,
            "seconds": wall, "tokens_per_s": st["total_tokens"] / wall, **st,
            "p50_per_token_latency_steps": float(np.percentile(lat, 50)),
            "p99_per_token_latency_steps": float(np.percentile(lat, 99)),
            "decode_ticks": len(probe.ms), "ms_per_tick": float(np.mean(probe.ms)),
            "decode_steps_run": len(probe.ms) * eng.tick_tokens,
            "decode_steps_after_all_done": len(probe.ms) * eng.tick_tokens - sum(probe.steps),
            "host_syncs_per_tick": {"min": min(probe.syncs), "max": max(probe.syncs),
                                    "mean": float(np.mean(probe.syncs)),
                                    "ticks": len(probe.syncs), "sites": dict(probe.sites)},
            "profiled_tick": probe.busy, "dense_replay": replay,
            "device_idle_share_of_timed_tick": None
            if not (probe.busy and probe.busy["device_busy_ms"])
            else 1 - probe.busy["device_busy_ms"] / float(np.mean(probe.ms)),
            "dense_sequential": solo,
            "continuous_speedup": solo["seconds"] / wall}
        check(out[sampler]["alloc_refused"] > 0,
              f"serve_continuous {sampler}: admission never waited on pages")
    emit({"phase": "serve_continuous", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": "bfloat16", **CONTINUOUS,
          "trace": CONT_TRACE, "layout_parity": parity,
          "batch_1_vs_batch_8": gap, **out, "seconds_by_part": parts,
          "seconds": time.perf_counter() - t_phase})
    return launches


def guards_serving(params) -> dict:
    """The guard layer on llama3-8b serving, on ``serve_continuous``'s weights and
    trace: a greedy ``ContinuousEngine`` run with checks off and one under
    ``guards.checks()`` (the same ``requests``, ``stats`` and streams; ms and host
    syncs a tick beside each other; no kernel launch either way); the page-budget
    guard of ``_decode_n`` firing under checks on a row placed past its budget;
    and ``ServeEngine(sampler="topp_kernel")`` under ``nonfinite_override(
    "sanitize")``, with the tokens and B7/B8 launches of the run without it."""
    t_phase = time.perf_counter()
    cfg = get_config("llama3-8b")
    trace = poisson_trace(vocab_size=cfg.vocab_size, **CONT_TRACE)
    eng = ContinuousEngine(cfg, params, sampler="greedy", **CONTINUOUS)
    per_alloc = alloc_launches(eng)
    eng.run(trace[:2])                                              # warm-up
    runs, out = {}, {}
    for name, on in (("checks_off", False), ("checks_on", True)):
        probe = TickProbe(eng, profile=-1)
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with guards.checks(on):
            runs[name] = eng.run(trace)
        sync()
        wall = time.perf_counter() - t0
        eng._decode_n = probe.orig
        calls = eng.alloc.calls                 # each run makes a fresh allocator
        expect_counts(ops.launch_counts(), f"guards_serving {name}",
                      **{k: v * calls for k, v in per_alloc.items()})
        out[name] = {"seconds": wall, "ms_per_tick": float(np.mean(probe.ms)),
                     "host_syncs_per_tick": probe.syncs,
                     "host_syncs_per_tick_median": float(np.median(probe.syncs))}
    check(_same_run(runs["checks_off"], runs["checks_on"]),
          "guards_serving: the run under checks() differs from the run without")
    check(out["checks_off"]["host_syncs_per_tick_median"] == 1
          and out["checks_on"]["host_syncs_per_tick_median"] == 2,
          f"guards_serving: host syncs a tick {out['checks_off']['host_syncs_per_tick']} "
          f"without checks, {out['checks_on']['host_syncs_per_tick']} with them")
    # the page budget: a running row placed past it fails the guard before any step
    cap = eng.n_blocks * eng.page_size
    fired = None
    ops.reset_launch_counts()
    with torch.inference_mode(), guards.checks():       # the engine's tensors' mode
        eng._pos[0], eng._done[0], eng._rem[0] = cap, False, 1
        try:
            eng._decode_n(eng.tick_tokens)
        except guards.GuardCheckError as e:
            fired = str(e)
    sync()
    eng._reset_rows()
    check(fired is not None and "page budget" in fired,
          f"guards_serving: the page-budget guard did not fire ({fired})")
    expect_counts(ops.launch_counts(), "guards_serving page budget")
    # the dense engine under nonfinite_override("sanitize")
    b, s, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    g = torch.Generator(device=DEV).manual_seed(GUARD_SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=DEV)}
    uniforms = torch.rand((new, b), generator=g, device=DEV)
    se = ServeEngine(cfg, params, max_len=s + new, sampler="topp_kernel")
    se.generate(batch, 2, uniforms=uniforms[:2])                    # warm-up
    toks, dense = {}, {}
    for name, ctx in (("propagate", contextlib.nullcontext()),
                      ("sanitize", guards.nonfinite_override("sanitize"))):
        ops.reset_launch_counts()
        with ctx:
            toks[name], secs = _timed_generate(se, batch, new, uniforms=uniforms)
        expect_counts(ops.launch_counts(), f"guards_serving topp_kernel {name}",
                      radix_pass=4 * new, topp_tail=new)
        dense[name] = {"seconds": secs, "tokens_per_s": b * new / secs}
    check(torch.equal(toks["propagate"], toks["sanitize"]),
          "guards_serving: topp_kernel under nonfinite_override('sanitize') drew other "
          "tokens")
    emit({"phase": "guards_serving", "arch": cfg.name, "trace": CONT_TRACE, **CONTINUOUS,
          "continuous_greedy": out, "page_budget_guard": fired,
          "serve_topp_kernel": dense, "seconds": time.perf_counter() - t_phase})
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# B6: the multi-way split
# ---------------------------------------------------------------------------


def _b6_hold(x, d, r, tag, plain: bool = True) -> int:
    """B6 on ``(x, d)`` against a stable argsort of the digits (out-of-range ones last)
    and their bincount and, where ``plain``, its plain version.  Returns the largest
    difference from the plain version (``z`` as raw words, ``ind``, counts)."""
    z, ind, cnt = split_mm.multi_split_tiles(x, d, num_buckets=r)
    worst = 0
    if plain:
        pz, pind, pcnt = split_mm.multi_split_plain(x, d, r)
        word = _WORD[z.element_size()]
        worst = max(int((z.view(word).long() - pz.view(word).long()).abs().max()),
                    int((ind.long() - pind.long()).abs().max()),
                    int((cnt.long() - pcnt.long()).abs().max()))
        check(torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt),
              f"{tag}: kernel != plain")
        del pz, pind, pcnt
    key = torch.where((d >= 0) & (d < r), d, r).long()
    order = torch.argsort(key, dim=-1, stable=True)
    check(torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order)),
          f"{tag}: != stable argsort of the digits")
    want = torch.stack([torch.bincount(row, minlength=r + 1)[:r] for row in key])
    check(torch.equal(cnt.long(), want), f"{tag}: counts != bincount of the digits")
    return worst


def b6_tile_edges(gen) -> dict:
    """One B6 launch per case at and around the edge of its tile split (rows of 1,
    TILE - 1, TILE, TILE + 1 and 3 TILE + 17 digits, runs of one digit across every
    tile edge, batches of 1 and 64, R = 2, 16 and 256), exact against the plain
    version, a stable argsort and a bincount."""
    tile, cases, worst = split_mm.RADIX_TILE, 0, 0
    for b in (1, 64):
        for n in tile_edge_rows(tile):
            x = torch.randn((b, n), generator=gen, device=DEV)
            for r in (2, B6_BUCKETS, 256):
                d = torch.randint(0, r, (b, n), generator=gen, device=DEV, dtype=torch.int32)
                for edge in range(tile, n, tile):
                    d[:, edge - 5:edge + 5] = d[:, edge - 5:edge - 4]
                tag = f"B6 tile edge b={b} n={n} R={r}"
                ops.reset_launch_counts()
                worst = max(worst, _b6_hold(x, d, r, tag))
                sync()
                expect_counts(ops.launch_counts(), tag, multi_split=1)
                cases += 1
    return {"tile": tile, "tile_edge_cases": cases, "tile_edge_max_abs_err": worst}


def phase_b6(gen):
    """The multi-way split kernel, exact: at (4, 2^24) fp32 against its plain version
    at R = 16 and against a stable argsort at R = 256 and R = 10 (the plain version's
    (b, R + 1, n) one-hot would take 68 GB at R = 256); at (4, 128259) a ragged row,
    R = 1, empty buckets, out-of-range digits, R = 511 and 512 on either side of the
    tile split's ceiling with 8-byte payloads, R = 5000 (the row kernel's 10 warps),
    bf16 and int32; the dist phase's vocab shards at R = 16; the tile edges."""
    cases, worst = [], 0
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    for r, plain in ((B6_BUCKETS, True), (256, False), (10, False)):
        d = torch.randint(0, r, SCAN_SHAPE, generator=gen, device=DEV, dtype=torch.int32)
        worst = max(worst, _b6_hold(x, d, r, f"B6 {list(SCAN_SHAPE)} R={r}", plain))
        cases.append({"shape": list(SCAN_SHAPE), "buckets": r, "payload": "float32",
                      "vs_plain": plain, "exact": True})
    del x, d
    shape = (SCAN_SHAPE[0], VOCAB + 3)                   # rows no multiple of 32
    xs = {"float32": torch.randn(shape, generator=gen, device=DEV)}
    xs["bfloat16"] = xs["float32"].to(torch.bfloat16)
    xs["int32"] = torch.randint(-(1 << 30), 1 << 30, shape, generator=gen, device=DEV,
                                dtype=torch.int32)
    rand = torch.randint(0, B6_BUCKETS, shape, generator=gen, device=DEV, dtype=torch.int32)
    sparse = torch.tensor([0, 7, 200], device=DEV)[rand % 3]          # 253 empty buckets
    wild = torch.randint(-5, B6_BUCKETS + 5, shape, generator=gen, device=DEV,
                         dtype=torch.int32)
    rows = [("ragged", "float32", rand, B6_BUCKETS, True),
            ("ragged", "bfloat16", rand, B6_BUCKETS, True),
            ("ragged", "int32", rand, B6_BUCKETS, True),
            ("one_bucket", "float32", torch.zeros_like(rand), 1, True),
            ("empty_buckets", "float32", sparse, 256, True),
            ("out_of_range_digits", "float32", wild, B6_BUCKETS, True),
            ("r5000_ten_warps", "float32",
             torch.randint(0, 5000, shape, generator=gen, device=DEV, dtype=torch.int32),
             5000, False)]
    xs["int64"] = xs["int32"].to(torch.int64) << 20
    top = split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS
    for r, name in ((top, "r511_tile_ceiling"), (top + 1, "r512_above_tile_ceiling")):
        d = torch.randint(-3, r + 3, shape, generator=gen, device=DEV, dtype=torch.int32)
        rows += [(name, "int64", d, r, True), (name, "float32", d, r, True)]
    for name, dt, d, r, plain in rows:
        worst = max(worst, _b6_hold(xs[dt], d, r, f"B6 {name} {dt} R={r}", plain))
        cases.append({"case": name, "shape": list(shape), "buckets": r, "payload": dt,
                      "vs_plain": plain, "exact": True,
                      "kernel": "tile split" if r <= top else "one CTA a row"})
    del xs
    for dd in DIST_WORLDS:                               # the dist phase's vocab shards
        sh = (VOCAB_ROWS, VOCAB // dd)
        x = torch.randn(sh, generator=gen, device=DEV)
        d = torch.randint(0, B6_BUCKETS, sh, generator=gen, device=DEV, dtype=torch.int32)
        worst = max(worst, _b6_hold(x, d, B6_BUCKETS, f"B6 shard D={dd}"))
        cases.append({"case": f"dist_shard_D{dd}", "shape": list(sh), "buckets": B6_BUCKETS,
                      "payload": "float32", "vs_plain": True, "exact": True})
    edges = b6_tile_edges(gen)
    worst = max(worst, edges["tile_edge_max_abs_err"])
    sync()
    emit({"phase": "b6", "cases": cases, **edges, "max_abs_err_vs_plain": worst})
    return worst


# ---------------------------------------------------------------------------
# B17: the SSD chunk kernel
# ---------------------------------------------------------------------------


def phase_b17(gen):
    """The SSD chunk kernel at zamba2's forward shapes against its plain version and
    the fp64 sequential oracle: on the ``ssd`` inputs and on a ragged S (views of
    them: the kernel reads through the strides) within ``SSD_REL``·max|y| of the plain
    version; with zamba2's init decays (a chunk's log-decay cumsum near -2e3) the
    distance to the plain version is reported; every case within the JAX package's
    2e-3 of fp64 and finite.  Then the chunk-parallel pass itself (``b17_pass``):
    five more calls bit-equal to the first on both decays, a CUDA-graph replay equal
    to the eager call, S of 1, Q - 1, Q, Q + 1 and 3Q + 17 (one launch, one CTA a
    chunk) and one (batch, head) of 256 chunks (every CTA waiting on the one before
    it), each within the same limits.
    Returns the largest kernel-plain difference held."""
    q = SSD["chunk"]
    res, worst = {}, 0.0
    base = ssd_inputs(gen)
    cases = (("ssd", base), ("zamba2_decays", zamba2_decay_inputs(gen)),
             ("ragged", tuple(t[:, :SSD_RAGGED_S] for t in base)))
    for name, args in cases:
        y = ssd_chunk.ssd_chunk_scan(*args, chunk=q)
        plain = ssd_chunk.ssd_chunk_plain(*args, chunk=q)
        ref = ssd_scan_ref(*(t.double() for t in args))
        check(bool(y.isfinite().all()) and bool(plain.isfinite().all()),
              f"B17 {name}: NaN or inf in the output")
        for who, out in (("kernel", y), ("plain", plain)):
            err = float(((out.double() - ref).abs() - 2e-3 * ref.abs()).max())
            check(err <= 2e-3, f"B17 {name}: {who} outside 2e-3 of the fp64 oracle ({err})")
        ymax = float(plain.abs().max())
        diff = float((y - plain).abs().max())
        if name != "zamba2_decays":
            check(diff <= SSD_REL * ymax, f"B17 {name}: kernel differs from plain by {diff} "
                  f"> {SSD_REL} * {ymax}")
            worst = max(worst, diff)
        res[name] = {"seq": int(args[0].shape[1]), "max_abs_y": ymax,
                     "max_abs_diff_vs_plain": diff, "rel_diff_vs_plain": diff / ymax,
                     "kernel_max_abs_err_vs_fp64": float((y.double() - ref).abs().max()),
                     "plain_max_abs_err_vs_fp64": float((plain.double() - ref).abs().max())}
        if name != "ragged":
            for i in range(5):
                check(torch.equal(ssd_chunk.ssd_chunk_scan(*args, chunk=q), y),
                      f"B17 {name}: call {i + 2} differs from the first")
            res[name]["repeat_calls_bit_equal"] = 5
    res["zamba2_decays"]["max_abs_log_decay_cumsum_per_chunk"] = float(
        cases[1][1][1].reshape(SSD["batch"], -1, q, SSD["heads"]).sum(2).abs().max())
    res["pass"] = b17_pass(gen, base)
    sync()
    emit({"phase": "b17", **SSD, "limit_rel_to_max_y": SSD_REL, **res})
    return worst


def _b17_hold(args, q, y, tag) -> float:
    """``y`` within ``SSD_REL``·max|y| of B17's plain version and 2e-3 of fp64, finite;
    returns its distance from the plain version over max|y|."""
    plain = ssd_chunk.ssd_chunk_plain(*args, chunk=q)
    ref = ssd_scan_ref(*(t.double() for t in args))
    err = float(((y.double() - ref).abs() - 2e-3 * ref.abs()).max())
    check(bool(y.isfinite().all()) and err <= 2e-3, f"{tag}: outside 2e-3 of fp64 ({err})")
    ymax = float(plain.abs().max())
    diff = float((y - plain).abs().max())
    check(diff <= SSD_REL * ymax, f"{tag}: kernel differs from plain by {diff} > "
          f"{SSD_REL} * {ymax}")
    return diff / ymax if ymax else 0.0


def _b17_launch(args, q):
    """One launch of B17 with its workspace; returns y and the CTAs that ran."""
    x, _, bm, _ = args
    bsz, s, h, p = x.shape
    nbytes = ssd_chunk.ssd_workspace_bytes(bsz * h, -(-s // q), bm.shape[-1], p)
    ws = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=DEV)
    y = ssd_chunk._ssd_chunk_cuda(*args, q, ws=ws)
    sync()
    return y, int(ws[0])


def b17_pass(gen, base) -> dict:
    """B17's chunk-parallel pass: a graph replay, the sequence edges and a 256-chunk
    chain (see ``phase_b17``)."""
    q = SSD["chunk"]
    out = {}
    x, al, bm, cm = (t[:, :1000].clone() for t in base)
    side = torch.cuda.Stream(DEV)
    side.wait_stream(torch.cuda.current_stream(DEV))
    with torch.cuda.stream(side):
        for _ in range(2):
            ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=q)
    torch.cuda.current_stream(DEV).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy = ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=q)
    for i in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device=DEV))
        graph.replay()
        sync()
        check(torch.equal(gy, ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=q)),
              f"B17 graph replay {i} != the eager call")
    out["graph_replays_equal"] = 3
    del graph, gy, x, al, bm, cm
    edges = {}
    for s_ in (1, q - 1, q, q + 1, 3 * q + 17):
        args = tuple(t[:, :s_] for t in base)
        ops.reset_launch_counts()
        y, ctas = _b17_launch(args, min(q, s_))
        expect_counts(ops.launch_counts(), f"B17 S={s_}", ssd_chunk=1)
        want = SSD["batch"] * SSD["heads"] * -(-s_ // q)
        check(ctas == want, f"B17 S={s_}: {ctas} CTAs ran for {want} chunks")
        edges[str(s_)] = _b17_hold(args, q, y, f"B17 S={s_}")
    out["seq_edges_rel_diff_vs_plain"] = edges
    chain = tuple(t[:1, :, :1].repeat(1, 256 * q // t.shape[1] + 1, *([1] * (t.dim() - 2)))
                  [:, :256 * q].contiguous() for t in base)
    y, ctas = _b17_launch(chain, q)
    check(ctas == 256, f"B17 chain of 256 chunks: {ctas} CTAs ran")
    out["chain_256_chunks"] = {"ctas": ctas, "rel_diff_vs_plain": _b17_hold(chain, q, y,
                                                                            "B17 chain")}
    return out


def main_multisplit(gen):
    """``multi_split(method="kernel")`` at (4, 2^24), R = 16, counters zeroed just
    before and read just after: exactly one B6 launch, and a stable split."""
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    d = torch.randint(0, B6_BUCKETS, SCAN_SHAPE, generator=gen, device=DEV,
                      dtype=torch.int32)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    z, ind, cnt = multi_split(x, d, B6_BUCKETS, method="kernel")
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    expect_counts(counts, "multi_split(method='kernel')", multi_split=1)
    order = torch.argsort(d, dim=-1, stable=True)
    check(torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order)),
          "multi_split(method='kernel') != stable argsort")
    want = torch.stack([torch.bincount(row.long(), minlength=B6_BUCKETS) for row in d])
    check(torch.equal(cnt.long(), want), "multi_split(method='kernel'): counts != bincount")
    emit({"phase": "main_multisplit", "shape": list(SCAN_SHAPE), "buckets": B6_BUCKETS,
          "launches": counts, "host_ms": host_ms})
    return counts


def forward_zamba2(gen):
    """zamba2-1.2b at full width and depth (38 layers, bf16 weights from seed 0):
    ``forward`` and ``loss`` on 4 x 2048 tokens and a ``loss_mask`` from numpy seed 0
    under each ``scan_method``, counters zeroed before each pass: 38 B17 launches on
    "kernel", 38 B4 + 38 B16 on "blocked", none on "vector".

    The ``ce`` of "kernel" and "blocked" is held to the one of "vector" within
    ``ZAMBA2_CE_TOL``, and two faults planted in the SSD's chunk cumsum under
    "blocked" (``ZAMBA2_FAULTS``: 10% short, zeroed) must read above it, so the
    check can fail.

    Then the fp32 SMOKE model under "kernel": its forward on the card is held within
    2e-5 of the same forward on the card with B17's plain version in the kernel's
    place, and against the same forward on the CPU (the plain versions everywhere)
    it may differ by at most twice what the "vector" forward (no B17) differs
    between the card and the CPU, plus 2e-5: cuBLAS and the CPU's BLAS round the
    model's other fp32 products apart by 2e-5 to 7e-5 already."""
    cfg = get_config("zamba2-1.2b")
    b, s = FORWARD["batch"], FORWARD["seq"]
    t0 = time.perf_counter()
    params = build_model(cfg).init(FORWARD["seed"], device=DEV, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(FORWARD["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    mask = torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.int32))
    batch = {"tokens": toks.to(DEV), "loss_mask": mask.to(DEV)}
    layers = cfg.n_layers
    wants = {"kernel": {"ssd_chunk": layers},
             "blocked": {"block_scan": layers, "linrec_block_scan": layers},
             "vector": {}}
    out, logits, launched = {}, {}, {k: 0 for k in ops.KERNELS}
    torch.cuda.reset_peak_memory_stats(DEV)
    for method, want in wants.items():
        model = build_model(dataclasses.replace(cfg, scan_method=method))
        model.forward(params, batch)                                       # warm-up
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lg = model.forward(params, batch)
        sync()
        fwd_s = time.perf_counter() - t0
        c_fwd = ops.launch_counts()
        expect_counts(c_fwd, f"zamba2 forward under scan_method={method!r}", **want)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        total, parts = model.loss(params, batch)
        sync()
        loss_s = time.perf_counter() - t0
        c_loss = ops.launch_counts()
        expect_counts(c_loss, f"zamba2 loss under scan_method={method!r}", **want)
        check(tuple(lg.shape) == (b, s, cfg.padded_vocab) and lg.dtype == torch.float32
              and bool(lg.isfinite().all()), f"zamba2 forward {method}: logits of shape "
              f"{tuple(lg.shape)} or not finite")
        check(bool(torch.isfinite(total)) and float(total) == float(parts["ce"])
              and float(parts["aux"]) == 0.0, f"zamba2 loss {method}: {total}, {parts}")
        for k in ops.KERNELS:
            launched[k] += c_fwd[k] + c_loss[k]
        logits[method] = lg
        out[method] = {"launches_per_pass": {k: v for k, v in c_fwd.items() if v},
                       "forward_ms": fwd_s * 1e3, "loss_ms": loss_s * 1e3,
                       "tokens_per_s": b * s / fwd_s, "ce": float(parts["ce"])}
    peak_gb = torch.cuda.max_memory_allocated(DEV) / 1e9
    ce_v = out["vector"]["ce"]
    for method in ("kernel", "blocked"):
        row_max = (logits[method][:, :-1] - logits["vector"][:, :-1]).abs().amax(-1)
        dce = abs(out[method]["ce"] - ce_v)
        check(dce <= ZAMBA2_CE_TOL, f"zamba2 ce under {method}: {out[method]['ce']} is "
              f"{dce} from vector's {ce_v}, beyond ZAMBA2_CE_TOL = {ZAMBA2_CE_TOL}")
        out[method].update(ce_abs_diff_vs_vector=dce,
                           logits_max_abs_diff_vs_vector=float(row_max.max()))
    del logits
    faults = {}
    blocked = build_model(dataclasses.replace(cfg, scan_method="blocked"))
    for name, fault in ZAMBA2_FAULTS.items():
        with planted(ssd_core, "mm_scan", fault):
            _, parts = blocked.loss(params, batch)
        faults[name] = abs(float(parts["ce"]) - ce_v)
        check(faults[name] > ZAMBA2_CE_TOL, f"zamba2 ce: the planted fault {name!r} reads "
              f"{faults[name]}, not above ZAMBA2_CE_TOL = {ZAMBA2_CE_TOL}: the check "
              "cannot see it")
    del params
    smoke = smoke_forward()
    emit({"phase": "forward_zamba2", "arch": cfg.name, "n_layers": layers, "dtype": "bfloat16",
          "batch": b, "seq": s, "loss_mask_share": float(mask.float().mean()),
          "init_s": init_s, "peak_mem_gb": peak_gb, **out, "ce_tol": ZAMBA2_CE_TOL,
          "ce_planted_faults": faults, "smoke_fp32": smoke})
    return launched


def _cumsum_short(x, **kw):
    """The chunk's log-decay cumsum 10% short: every decay within a chunk too weak."""
    return 0.9 * scan(x, **kw)


def _cumsum_zeroed(x, **kw):
    """The chunk's log-decay cumsum lost (a scan that wrote zeros): no decay."""
    return torch.zeros_like(scan(x, **kw))


# faults planted in ssd_scan's chunk cumsum, the scan that B4 runs under "blocked"
# (forward_zamba2's ce check).  Not in the cross-chunk recurrence: at zamba2's
# init a chunk's decay exp(cs_Q) is ~e^-90 (128 tokens of A·dt ~ 0.7 and up), so
# the states carried across chunks barely reach the logits
ZAMBA2_FAULTS = {"cumsum_10pct_short": _cumsum_short, "cumsum_zeroed": _cumsum_zeroed}


@contextlib.contextmanager
def planted(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def smoke_forward():
    """The fp32 SMOKE zamba2 forward under "kernel" (5 B17 launches) on the card,
    against B17's plain version on the card and against the CPU (see
    ``forward_zamba2``); and on the inputs of ``tests/test_torch_cuda.py``'s
    ``test_forward_launches_b17_once_per_mamba_layer`` (weights from seed 0, tokens
    from torch's seed 0), the tightest case of B17's 2e-5 logit limit in the card
    tests, against B17's plain version on the card."""
    scfg = get_config("zamba2-1.2b", smoke=True)
    sparams = build_model(scfg).init(1, device="cpu")
    gparams = _to(sparams, DEV)
    stoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, scfg.vocab_size, (2, 48)).astype(np.int32))
    card, cpu = {}, {}
    for method in ("kernel", "vector"):
        smodel = build_model(dataclasses.replace(scfg, scan_method=method))
        ops.reset_launch_counts()
        card[method] = smodel.forward(gparams, {"tokens": stoks.to(DEV)})
        sync()
        expect_counts(ops.launch_counts(), f"SMOKE zamba2 forward under {method!r}",
                      **({"ssd_chunk": scfg.n_layers} if method == "kernel" else {}))
        cpu[method] = smodel.forward(sparams, {"tokens": stoks})
    kernel_model = build_model(dataclasses.replace(scfg, scan_method="kernel"))
    swapped = mamba_model.ssd_chunk_scan
    mamba_model.ssd_chunk_scan = ssd_chunk.ssd_chunk_plain        # B17's plain version
    try:
        plain_card = kernel_model.forward(gparams, {"tokens": stoks.to(DEV)})
    finally:
        mamba_model.ssd_chunk_scan = swapped
    tparams = _to(build_model(scfg).init(0, device="cpu"), DEV)
    ttoks = torch.randint(0, scfg.vocab_size, (2, 48),
                          generator=torch.Generator().manual_seed(0)).to(DEV)
    tk = kernel_model.forward(tparams, {"tokens": ttoks})
    mamba_model.ssd_chunk_scan = ssd_chunk.ssd_chunk_plain
    try:
        tp = kernel_model.forward(tparams, {"tokens": ttoks})
    finally:
        mamba_model.ssd_chunk_scan = swapped
    res = {"kernel_vs_plain_on_card": float((card["kernel"] - plain_card).abs().max()),
           "card_test_inputs_kernel_vs_plain_on_card": float((tk - tp).abs().max()),
           **{f"{m}_card_vs_cpu": float((card[m].cpu() - cpu[m]).abs().max())
              for m in card},
           "max_abs_logit": float(cpu["vector"].abs().max())}
    res["kernel_card_vs_cpu_limit"] = 2 * res["vector_card_vs_cpu"] + 2e-5
    for key in ("kernel_vs_plain_on_card", "card_test_inputs_kernel_vs_plain_on_card"):
        check(res[key] <= 2e-5, f"SMOKE zamba2 forward ({key}): B17 on the card differs "
              f"from its plain version by {res[key]}")
    check(res["kernel_card_vs_cpu"] <= res["kernel_card_vs_cpu_limit"],
          f"SMOKE zamba2 forward under 'kernel' on the card is {res['kernel_card_vs_cpu']} "
          f"from the CPU, beyond {res['kernel_card_vs_cpu_limit']}")
    return res


# ---------------------------------------------------------------------------
# train: zamba2-1.2b training at full width, linear_scan's adjoint, the resume
# ---------------------------------------------------------------------------

# launch/train.py's AdamW (warmup 20, decay over the run), SyntheticLM batches
TRAIN = dict(batch=4, seq=2048, steps=10, seed=0, lr=1e-3)
TRAIN_SMOKE = dict(batch=4, seq=64, steps=4, ckpt=2)
ADJOINT_ROWS = ((4, 1 << 20), (4, 1 << 24))
ADJOINT_REPS = 5
# the adjoint against fp64 "vector" autograd, in fp32 spacings: b̄ = λ is the
# reverse recurrence, held as the forward is, within 16 ulp at the scale of the
# recurrence on |ash|, |ḡ| (Λ); ā = λ·y_prev carries λ's 16, y's 16 and one
# rounding at the scale Λ·Y (Y: the recurrence on |a|, |b|), and a sum over k
# elements sharing a decay (the SSD's (N, P) state: 4096) ⌈log2 k⌉ more
ADJ_B_ULP = 16
ADJ_A_ULP = 33
# the "vector" step's gradients against the "auto" step's, by config: each leaf
# within ``leaf``·max|g_leaf| and the norm within ``norm`` relative.  From the init
# state the two are bit-equal (a chunk's decay e^-90 underflows, so both hand on
# each chunk's own state; an H100 at 700 W read 0 three times), so they are also
# compared with every dt_bias at softplus⁻¹(SLOW_DT) (dt ~ 0.01: chunk decays e^-1
# to e^-20, the states carried on).  In the config's bf16 on the first batch, 38
# random bf16 layers amplify the last bits in which B16's walk and the doubling
# differ: read 0.200 (worst leaf) and 2.2e-3 (norm), and a one-ulp nudge of the
# carried states alone 0.271 and 6.3e-4 (at init 2.37 and 0.238), so that limit
# only catches gross faults.  In fp32 on its first row: read 7.7e-5 and 2.0e-7
# (the nudge 5.8e-5 and 3.4e-7); there the adjoint with ā dropped
# (``TRAIN_GRAD_FAULTS``) read 1.09 and must read above the limit
TRAIN_GRAD_TOL = {"init": dict(leaf=0.0, norm=0.0),
                  "slow_bf16": dict(leaf=0.6, norm=5e-3),
                  "slow_fp32": dict(leaf=3e-4, norm=1e-6)}
SLOW_DT = 0.01


def _leaf_diffs(got, ref, path=""):
    """The largest ``max|got - ref| / max|ref|`` over the leaves of two gradient
    trees, and the leaf's path."""
    if isinstance(ref, dict):
        return max((_leaf_diffs(got[k], ref[k], f"{path}/{k}") for k in ref),
                   key=lambda t: t[0])
    den = float(ref.abs().max())
    return float((got.float() - ref.float()).abs().max()) / max(den, 1e-30), path


def _slow_decay(params):
    """``params`` (the same tensors) with every Mamba2 layer's ``dt_bias`` at
    ``softplus⁻¹(SLOW_DT)``."""
    if not isinstance(params, dict):
        return params
    return {k: (torch.full_like(v, math.log(math.expm1(SLOW_DT))) if k == "dt_bias"
                else _slow_decay(v)) for k, v in params.items()}


def _norm(tree) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in tree_leaves(tree))))


def _nudged(a, b, **kw):
    """The cross-chunk states one fp32 ulp high (a control of the amplification)."""
    return linear_scan(a, b, **kw) * (1.0 + 2.0 ** -23)


@contextlib.contextmanager
def _adjoint_without_a():
    """The column walk's adjoint with ā dropped (a planted fault)."""
    cls = linrec_core._LinrecColumns
    orig = cls.__dict__["backward"]

    def backward(ctx, g):
        ga, *rest = orig.__func__(ctx, g)
        return (None if ga is None else torch.zeros_like(ga), *rest)

    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = orig


TRAIN_GRAD_FAULTS = {"walk_adjoint_without_a": _adjoint_without_a}


def vector_vs_auto(tr, vec, params, batch, tol, faults=None, nudge=True) -> dict:
    """The gradients of one batch on "auto" (twice: their spread; and, with
    ``nudge``, with the carried states nudged by an ulp) and on "vector" from
    ``params``: losses, norms and the worst leaf's relative difference, within
    ``tol``; each of ``faults`` (name -> context manager) planted in "auto" must
    read above it."""
    loss_a, _, g_auto = tr.grads(params, batch)
    ops.reset_launch_counts()
    loss_v, _, g_vec = vec.grads(params, batch)
    sync()
    expect_counts(ops.launch_counts(), "zamba2 gradients on 'vector'")
    norm_a, norm_v = _norm(g_auto), _norm(g_vec)
    leaf, where = _leaf_diffs(g_vec, g_auto)
    out = {"loss_auto": float(loss_a), "loss_vector": float(loss_v),
           "grad_norm_auto": norm_a, "grad_norm_vector": norm_v,
           "norm_rel_diff_vector": abs(norm_v - norm_a) / norm_a,
           "leaf_rel_diff_vector": leaf, "worst_leaf": where}
    for name, fault in (faults or {}).items():
        with fault():
            _, _, g_f = tr.grads(params, batch)
        out[f"fault_{name}"] = {"leaf_rel_diff_vector": _leaf_diffs(g_f, g_vec)[0],
                                "norm_rel_diff_vector": abs(_norm(g_f) - norm_v) / norm_v}
        del g_f
        check(out[f"fault_{name}"]["leaf_rel_diff_vector"] > tol["leaf"],
              f"zamba2 gradients: the planted fault {name!r} reads {out[f'fault_{name}']}, "
              f"not above {tol}: the check cannot see it")
    del g_vec
    for tag, ctx in (("auto_twice", contextlib.nullcontext()),
                     ("ulp_nudge", planted(ssd_core, "linear_scan", _nudged)))[:1 + nudge]:
        with ctx:
            _, _, g_again = tr.grads(params, batch)
        out[f"leaf_rel_diff_{tag}"] = _leaf_diffs(g_again, g_auto)[0]
        out[f"norm_rel_diff_{tag}"] = abs(_norm(g_again) - norm_a) / norm_a
        del g_again
    check(out["norm_rel_diff_vector"] <= tol["norm"]
          and out["leaf_rel_diff_vector"] <= tol["leaf"],
          f"zamba2 gradients: 'vector' against 'auto' {out}, limits {tol}")
    return out


def adjoint_check(a, b, g, axis: int, method: str, want: dict, **kw) -> dict:
    """``linear_scan``'s adjoint on ``method`` against fp64 "vector" autograd.

    ``(ā, b̄)`` from ``torch.autograd.grad`` with the cotangent ``g``: launches
    exactly ``want`` a backward pass; within ``ADJ_B_ULP`` / ``ADJ_A_ULP`` (+
    ``⌈log2 k⌉``) of fp64 at the scales the module constants state; the same
    bits over ``ADJOINT_REPS`` forward + backward calls; the forward's and the
    backward's ms."""
    def grads(a_, b_, g_, m):
        ar, br = a_.detach().requires_grad_(), b_.detach().requires_grad_()
        y = linear_scan(ar, br, axis=axis, method=m, **kw)
        return torch.autograd.grad(y, (ar, br), g_)

    a64, b64, g64 = a.double(), b.double(), g.double()
    ga64, gb64 = grads(a64, b64, g64, "vector")
    sa, sb = grads(a64.abs(), b64.abs(), g64.abs(), "vector")   # Σ Λ·Y and Λ
    k = math.prod(b.shape) // math.prod(a.shape)
    runs = []
    for _ in range(ADJOINT_REPS):
        ops.reset_launch_counts()
        ar, br = a.detach().requires_grad_(), b.detach().requires_grad_()
        y = linear_scan(ar, br, axis=axis, method=method, **kw)
        sync()
        fwd_counts = ops.launch_counts()
        fwd_walks = _build.LAUNCHES["linrec_summaries_carries"]
        ops.reset_launch_counts()
        runs.append(torch.autograd.grad(y, (ar, br), g))
        sync()
        expect_counts(ops.launch_counts(), f"{method} adjoint at {tuple(b.shape)}", **want)
        expect_counts(fwd_counts, f"{method} forward at {tuple(b.shape)}", **want)
        # every B14 of the rows' pipeline runs B15's walk in its launch
        walks = want.get("linrec_summaries", 0)
        fused_walks(f"{method} adjoint at {tuple(b.shape)}", walks, "linrec_summaries_carries")
        check(fwd_walks == walks, f"{method} forward at {tuple(b.shape)}: {fwd_walks} "
              f"fused B14 + B15 launches, not {walks}")
    same = all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1])
               for r in runs[1:])
    check(same, f"{method} adjoint at {tuple(b.shape)}: {ADJOINT_REPS} calls differ")
    ga, gb = runs[0]
    ulp_a = max_ulp_dev(ga, ga64, sa)
    ulp_b = max_ulp_dev(gb, gb64, sb)
    lim_a = ADJ_A_ULP + math.ceil(math.log2(k)) if k > 1 else ADJ_A_ULP
    check(ulp_b <= ADJ_B_ULP and ulp_a <= lim_a,
          f"{method} adjoint at {tuple(b.shape)}: b̄ {ulp_b} ulp (limit {ADJ_B_ULP}), "
          f"ā {ulp_a} ulp (limit {lim_a}) from fp64")
    ar, br = a.detach().requires_grad_(), b.detach().requires_grad_()
    y = linear_scan(ar, br, axis=axis, method=method, **kw)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: linear_scan(a, b, axis=axis, method=method, **kw), 10)
    adj_ms = cuda_ms(lambda: torch.autograd.grad(y, (ar, br), g, retain_graph=True), 10)
    return {"launches_a_backward": {k_: v for k_, v in want.items()},
            "grad_a_ulp": ulp_a, "grad_a_ulp_limit": lim_a, "grad_b_ulp": ulp_b,
            "grad_b_ulp_limit": ADJ_B_ULP, "same_bits_over_calls": ADJOINT_REPS,
            "forward_ms": fwd_ms, "adjoint_ms": adj_ms}


def adjoint_phase(gen, cross) -> dict:
    """The adjoint on the card: rows at ``ADJOINT_ROWS`` (B13; B14–B16) and one
    Mamba2 layer's real cross-chunk pairs ``cross`` (the column walk of B13 and of
    B16), with the layer's decays and with decays in [0.9, 1), each against fp64
    with a random cotangent."""
    out = {}
    rows_want = {"kernel": {"linrec_scan": 1},
                 "blocked": {"linrec_summaries": 1, "linrec_block_scan": 1}}
    for shape in ADJOINT_ROWS:
        a, b = lin_inputs(gen, shape)["random"]
        g = torch.randn(shape, generator=gen, device=DEV)
        for method, want in rows_want.items():
            out[f"rows{shape}/{method}"] = adjoint_check(a, b, g, -1, method, want)
        del a, b, g
    a, b, kw = cross["a"], cross["b"], cross["kw"]
    g = torch.randn(b.shape, generator=gen, device=DEV)
    # the layer's own decays underflow (e^-90: λ = ḡ), so the walk is also held on
    # its states with decays in [0.9, 1), which carry every chunk on
    decays = {"layer0": a, "decays_0.9_1": 0.9 + 0.1 * torch.rand(a.shape, generator=gen,
                                                                     device=DEV)}
    for tag, ad in decays.items():
        for method, name in (("kernel", "linrec_scan"), ("blocked", "linrec_block_scan")):
            out[f"walk{tuple(b.shape)}/{tag}/{method}"] = adjoint_check(
                ad, b, g, 1, method, {name: 1}, tile_s=kw["tile_s"])
    out["layer0_max_chunk_decay"] = float(a.max())
    return out


def train_resume() -> dict:
    """The SMOKE model (fp32) on the card: a run of ``TRAIN_SMOKE["steps"]`` steps,
    twice (the spread of the last step's loss), and the same run stopped at a
    checkpoint and resumed by a fresh trainer: its last loss bit-equal to the
    uninterrupted run's, or within their spread."""
    scfg = get_config("zamba2-1.2b", smoke=True)
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=2, total_steps=10)
    n, at = TRAIN_SMOKE["steps"], TRAIN_SMOKE["ckpt"]
    src = SyntheticLM(scfg.vocab_size, TRAIN_SMOKE["seq"], TRAIN_SMOKE["batch"])
    runs = [Trainer(scfg, opt, device=DEV).fit(src, n, log_every=0)["losses"]
            for _ in range(2)]
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    Trainer(scfg, opt, ckpt_dir=d, device=DEV).fit(src, at, ckpt_every=at, log_every=0)
    logs = []
    tr = Trainer(scfg, opt, ckpt_dir=d, device=DEV)
    resumed = tr.fit(src, n, log_every=0, log=logs.append)["losses"]
    shutil.rmtree(d, ignore_errors=True)
    spread = abs(runs[0][-1] - runs[1][-1])
    diff = abs(resumed[-1] - runs[0][-1])
    check(logs == [f"[trainer] resumed from step {at}"] and len(resumed) == n - at,
          f"resume: {logs}, {len(resumed)} steps run")
    check(diff <= spread, f"resume: the resumed run's last loss {resumed[-1]} is {diff} "
          f"from the uninterrupted run's {runs[0][-1]}, beyond their spread {spread}")
    return {"steps": n, "checkpoint_at": at, "losses": runs[0], "resumed_losses": resumed,
            "last_loss_diff": diff, "spread_of_two_runs": spread,
            "bit_equal": resumed[-1] == runs[0][-1]}


def phase_train(gen):
    """zamba2-1.2b (arXiv:2411.15242) trained at full width and depth: fp32 params and
    AdamW state, the config's bf16 compute and remat, ``scan_method="auto"``.

    Each step launches 38 × 3 B16 column walks (the cross-chunk states' forward,
    its remat recompute and the adjoint) and nothing else: the chunk's cumsum
    resolves to "vector" at n = 128 (no B1), and no B17.  Before training, the
    gradients of the first batch on "auto" (twice: their spread) and on
    "vector" (no launch) from the same state, and from it with slow decays
    (``_slow_decay``) in bf16 and, on one row, in fp32; the losses of ``TRAIN["steps"]``
    steps finite and falling; step ms, tokens/s and peak memory; the last step
    profiled for the B16 launches' device time.  A ``"kernel"`` step is refused
    before any launch.  Then the adjoint checks (``adjoint_phase``, on layer 0's
    cross-chunk pairs from the first step) and the SMOKE resume (``train_resume``).
    Returns the training loop's launches."""
    t_phase = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.scan_method == "auto",
          f"zamba2 config: remat {cfg.remat}, dtype {cfg.dtype}, {cfg.scan_method}")
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=20, total_steps=steps)
    tr = Trainer(cfg, opt, device=DEV)
    sync()
    t0 = time.perf_counter()
    state = tr.init_state(TRAIN["seed"])
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    src = SyntheticLM(cfg.vocab_size, s, b)
    batch0 = {k: torch.as_tensor(v).to(DEV) for k, v in src.batch_at(0).items()}
    per_step = {"linrec_block_scan": 3 * cfg.n_layers}

    cross = {}
    orig = ssd_core.linear_scan

    def capture(a, b_, **kw):
        if not cross:
            cross.update(a=a.detach().clone(), b=b_.detach().clone(), kw=kw)
        return orig(a, b_, **kw)

    ops.reset_launch_counts()
    with planted(ssd_core, "linear_scan", capture):
        tr.grads(state["params"], batch0)
    sync()
    expect_counts(ops.launch_counts(), "zamba2 gradients on 'auto'", **per_step)
    check(tuple(cross["b"].shape) == (b, s // cfg.ssm.chunk, cfg.ssm.n_heads,
                                      cfg.ssm.d_state, cfg.ssm.head_dim),
          f"zamba2 cross-chunk pairs {tuple(cross['b'].shape)}")
    vec = Trainer(dataclasses.replace(cfg, scan_method="vector"), opt, device=DEV)
    slow = _slow_decay(state["params"])
    grads = {"init": vector_vs_auto(tr, vec, state["params"], batch0,
                                    TRAIN_GRAD_TOL["init"], nudge=False),
             "slow_bf16": vector_vs_auto(tr, vec, slow, batch0, TRAIN_GRAD_TOL["slow_bf16"])}
    c32 = dataclasses.replace(cfg, dtype="float32")
    grads["slow_fp32"] = vector_vs_auto(
        Trainer(c32, opt, device=DEV),
        Trainer(dataclasses.replace(c32, scan_method="vector"), opt, device=DEV), slow,
        {k: v[:1] for k, v in batch0.items()}, TRAIN_GRAD_TOL["slow_fp32"],
        TRAIN_GRAD_FAULTS)
    del slow

    refused = Trainer(dataclasses.replace(cfg, scan_method="kernel"), opt, device=DEV)
    ops.reset_launch_counts()
    try:
        refused.train_step(state, src.batch_at(0))
        raised = False
    except NotImplementedError as e:
        raised = "has no gradient" in str(e)
    sync()
    check(raised and int(state["opt"]["step"]) == 0, "a 'kernel' zamba2 step was not refused")
    expect_counts(ops.launch_counts(), "the refused 'kernel' zamba2 step")

    _free()
    torch.cuda.reset_peak_memory_stats(DEV)
    losses, step_ms, norms, launched = [], [], [], {k: 0 for k in ops.KERNELS}
    prof_rec = None
    for step in range(steps):
        batch = src.batch_at(step)
        sync()
        ops.reset_launch_counts()
        profile = step == steps - 1
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=acts) if profile
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            state, metrics = tr.train_step(state, batch)
            loss = float(metrics["loss"])
            sync()
            dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        expect_counts(counts, f"zamba2 train step {step}", **per_step)
        for k in ops.KERNELS:
            launched[k] += counts[k]
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        if profile:
            dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            walks = [e for e in dev if "column_walk" in e.name]
            busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
            prof_rec = {"step": step, "wall_ms": dt * 1e3,
                        "device_busy_ms": busy if dev else None,
                        "device_idle_share": 1 - busy / (dt * 1e3) if dev else None,
                        "b16_launches": len(walks),
                        "b16_device_ms": (sum(e.time_range.elapsed_us() for e in walks) / 1e3
                                          if walks else None)}
        else:
            step_ms.append(dt * 1e3)
    peak_gb = torch.cuda.max_memory_allocated(DEV) / 1e9
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"zamba2 training losses {losses}: not finite or not falling")
    check(int(state["opt"]["step"]) == steps, "zamba2 training: AdamW's step count")
    del state
    _free()
    adjoint = adjoint_phase(gen, cross)
    del cross
    resume = train_resume()
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "params": n_params, "param_dtype": "float32", "compute_dtype": cfg.dtype,
          "remat": cfg.remat, "scan_method": cfg.scan_method, "batch": b, "seq": s,
          "init_s": init_s, "launches_per_step": per_step, "losses": losses,
          "grad_norms": norms, "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms),
          "tokens_per_s": b * s / (statistics.median(step_ms) / 1e3),
          "peak_mem_gb": peak_gb, "profiled_step": prof_rec, "first_batch_grads": grads,
          "grad_tol": TRAIN_GRAD_TOL, "slow_dt": SLOW_DT,
          "adjoint": adjoint,
          "resume_smoke": resume, "seconds": time.perf_counter() - t_phase})
    return launched


# ---------------------------------------------------------------------------
# models: the MoE, qk-norm and local/global families at full width
# ---------------------------------------------------------------------------


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _first(tree):
    """Layer 0 of a stacked parameter tree."""
    return {k: _first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def _sum_counts(*counts) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in ops.KERNELS}


def _init_bf16(cfg, seed: int):
    sync()
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed, device=DEV, dtype=torch.bfloat16)
    sync()
    return params, time.perf_counter() - t0, sum(t.numel() for t in _leaves(params))


def host_syncs(fn) -> int:
    """Host syncs that ``fn`` makes (``torch.cuda.set_sync_debug_mode`` warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def serve_family(cfg, params, gen, *, batch: int, prompt: int, new: int, method: str,
                 per_pass, extra=None) -> dict:
    """``ServeEngine(sampler="topp_kernel")`` on ``cfg`` under ``scan_method=method``:
    a warm-up, then the timed run with the counters zeroed just before and read just
    after, exact against ``per_pass(n)`` (the model's launches of one pass over ``n``
    tokens; a decode step is a pass over ``batch``) plus the sampler's 4 B7 + 1 B8 a
    token; a prefill and one sample alone, likewise; the prefill timed alone and one
    decode step's launches, exact; every sampled token held to its window.  ``extra``
    holds the family's stub embeddings (``enc_embed``, ``img_embed``); a VLM's image
    tokens count in ``max_len`` and in the decode positions."""
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                                    device=DEV), **(extra or {})}
    uniforms = torch.rand((new, batch), generator=gen, device=DEV)
    off = cfg.n_img_tokens if cfg.family == "vlm" else 0
    eng = ServeEngine(cfg, params, max_len=prompt + off + new, sampler="topp_kernel",
                      scan_method=method)
    eng.generate(toks, 2, uniforms=uniforms[:2])                        # warm-up
    ops.reset_launch_counts()
    out, t_full = _timed_generate(eng, toks, new, uniforms=uniforms)
    counts = ops.launch_counts()
    want = _sum_counts(per_pass(batch * prompt), *[per_pass(batch)] * (new - 1),
                       {"radix_pass": 4 * new, "topp_tail": new})
    expect_counts(counts, f"{cfg.name} serving under scan_method={method!r}", **want)
    check(tuple(out.shape) == (batch, new) and bool(((out >= 0) & (out < cfg.vocab_size))
                                                   .all()),
          f"{cfg.name} {method}: tokens of shape {tuple(out.shape)} or out of range")
    ops.reset_launch_counts()
    _, t_one = _timed_generate(eng, toks, 1, uniforms=uniforms[:1])
    expect_counts(ops.launch_counts(), f"{cfg.name} {method}: prefill and one sample",
                  **_sum_counts(per_pass(batch * prompt), {"radix_pass": 4, "topp_tail": 1}))
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches = eng.model.prefill(params, toks, cache_len=prompt + off + new)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = torch.argmax(logits, -1)[:, None]
        ops.reset_launch_counts()
        syncs = host_syncs(lambda: eng.model.decode_step(params, tok, caches, prompt + off))
        sync()
        expect_counts(ops.launch_counts(), f"{cfg.name} {method}: one decode step",
                      **per_pass(batch))
    sampled = check_sampled(eng, toks, uniforms, out, new)
    return {"launches": {k: v for k, v in counts.items() if v}, "counts": counts,
            "batch": batch, "prompt": prompt, "new_tokens": new, "prefill_ms": prefill_ms,
            "prefill_plus_first_sample_ms": t_one * 1e3,
            "decode_step_ms": (t_full - t_one) / (new - 1) * 1e3,
            "model_host_syncs_per_decode_step": syncs,
            "tokens_per_s": batch * new / t_full, "generate_s": t_full, **sampled}


def moe_per_pass(cfg, method: str):
    """The launches of one pass of ``cfg``'s MoE layers over ``n`` tokens: one
    segmented mask scan a layer over the (E, n·K) one-hot (``seg_counts``)."""
    layers = cfg.n_layers - cfg.moe.first_k_dense

    def per_pass(n):
        return seg_counts(method, n * cfg.moe.top_k, layers) if method != "vector" else {}
    return per_pass


def moe_dispatch_check(cfg, params, eidx) -> dict:
    """One layer's real routing (``eidx``, (1, T·K)): the positions of both dispatch
    modes on "kernel" (B9, B1) and "blocked" (B12, B4, one block a row), each one
    launch, bit-equal to one another and to an int64 cumsum of the one-hot; B9 and
    B12 also against their plain versions on the same one-hot on the card.  Then the
    dispatch scan's ms beside the layer's expert GEMMs' ms at this routing's capacity,
    and B9's and B12's ms on the one-hot (eager and as graph replays), where most of
    their launches run, beside its byte bound (the one-hot and flags in, int32 out)."""
    e = cfg.moe.n_experts
    onehot = torch.nn.functional.one_hot(eidx.to(torch.int64), e)              # (1, N, E)
    ref = torch.gather(torch.cumsum(onehot, 1) - onehot, 2,
                       eidx.to(torch.int64)[..., None])[..., 0]
    wants = {("kernel", "segmented"): {"seg_scan": 1}, ("kernel", "grouped"): {"scan_mm": 1},
             ("blocked", "segmented"): seg_counts("blocked", eidx.shape[1], 1),
             ("blocked", "grouped"): {"block_scan": 1}}
    if scan_pipeline.block_geometry(eidx.shape[1], 128, 8)[2] > 1:
        wants[("blocked", "grouped")] = {"block_sums": 1, "block_scan": 1}
    pos = {}
    for (method, mode), want in wants.items():
        ops.reset_launch_counts()
        pos[(method, mode)] = moe_model.dispatch_positions(eidx, e, scan_method=method,
                                                           mode=mode)
        sync()
        expect_counts(ops.launch_counts(), f"MoE dispatch {method}/{mode}", **want)
        check(torch.equal(pos[(method, mode)].to(torch.int64), ref),
              f"MoE dispatch {method}/{mode}: positions != the int64 cumsum")
    oh8 = (eidx[0][None, :] == torch.arange(e, device=DEV)[:, None]).to(torch.int8)
    flags = torch.zeros(oh8.shape[1], dtype=torch.int8, device=DEV)
    flags[0] = 1
    b9 = segscan_mm.seg_scan_tiles(oh8, flags)
    b12 = segscan_mm.seg_blocked_scan(oh8, flags)
    plain = segscan_mm.seg_scan_tiles_plain(oh8, (flags != 0).expand(oh8.shape), s=128,
                                            acc=torch.int32)
    check(torch.equal(b9, plain) and torch.equal(b12, plain),
          "MoE one-hot: B9 / B12 differ from B9's plain version")
    scan_ms = cuda_ms(lambda: moe_model.dispatch_positions(
        eidx, e, scan_method="kernel", mode="segmented"), 20)
    syncs = host_syncs(lambda: moe_model.dispatch_positions(
        eidx, e, scan_method="kernel", mode="segmented"))
    b9_ms = cuda_ms(lambda: segscan_mm.seg_scan_tiles(oh8, flags), 20)
    b9_device_ms = graph_ms(lambda: segscan_mm.seg_scan_tiles(oh8, flags), 20)
    b9_bound_ms, _ = bound(oh8.numel() + flags.numel() + 4 * oh8.numel())
    ops.reset_launch_counts()
    segscan_mm.seg_blocked_scan(oh8, flags)
    b12_launches = {k: v for k, v in ops.launch_counts().items() if v}
    b12_ms = cuda_ms(lambda: segscan_mm.seg_blocked_scan(oh8, flags), 20)
    b12_device_ms = graph_ms(lambda: segscan_mm.seg_blocked_scan(oh8, flags), 20)
    cap = moe_model.capacity_of(eidx.shape[1] // cfg.moe.top_k, cfg)
    w = _first(params["stack"]["sub0"]["moe"]["experts"])
    ex_in = torch.randn((e, cap, cfg.d_model), generator=torch.Generator(DEV).manual_seed(5),
                        device=DEV).to(torch.bfloat16)
    gemm_ms = cuda_ms(lambda: moe_model._expert_ffn(ex_in, w, cfg.act), 5)
    return {"assignments": int(eidx.shape[1]), "capacity": cap,
            "positions_equal_int64_cumsum": True, "grouped_equal_segmented": True,
            "max_position": int(ref.max()),
            "dropped": int((ref >= cap).sum()),
            "dispatch_scan_ms": scan_ms, "dispatch_host_syncs": syncs,
            "b9_ms": b9_ms, "b9_device_ms": b9_device_ms, "b9_bound_ms": b9_bound_ms,
            "b12_ms": b12_ms, "b12_device_ms": b12_device_ms, "b12_bound_ms": b9_bound_ms,
            "b12_launches_a_call": b12_launches, "one_hot_shape": list(oh8.shape),
            "expert_gemms_ms": gemm_ms,
            "dispatch_share_of_layer_moe": scan_ms / (scan_ms + gemm_ms)}


def forward_moe(cfg, params) -> dict:
    """``forward`` / ``loss`` of ``cfg`` on ``MODELS_FORWARD``'s tokens under "kernel",
    "blocked" and "vector": exact launches a pass (27 B9, 27 B12, none), the logits,
    ``ce`` and ``aux`` bit-equal across the three (the positions are exact integers),
    and one layer's routing recorded for ``moe_dispatch_check``."""
    b, s = MODELS_FORWARD["batch"], MODELS_FORWARD["seq"]
    rng = np.random.default_rng(MODELS_FORWARD["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    mask = torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.int32))
    batch = {"tokens": toks.to(DEV), "loss_mask": mask.to(DEV)}
    out, ref, launched, routing = {}, None, {k: 0 for k in ops.KERNELS}, []
    real_dispatch = moe_model.dispatch

    def record(expert_idx, *a, **kw):
        if not routing:
            routing.append(expert_idx.reshape(1, -1).clone())
        return real_dispatch(expert_idx, *a, **kw)

    for method in ("vector", "kernel", "blocked"):
        model = build_model(dataclasses.replace(cfg, scan_method=method))
        moe_model.dispatch = record
        try:
            model.forward(params, batch)                                   # warm-up
        finally:
            moe_model.dispatch = real_dispatch
        want = moe_per_pass(cfg, method)(b * s)
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lg = model.forward(params, batch)
        sync()
        fwd_s = time.perf_counter() - t0
        c_fwd = ops.launch_counts()
        expect_counts(c_fwd, f"{cfg.name} forward under scan_method={method!r}", **want)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        total, parts = model.loss(params, batch)
        sync()
        loss_s = time.perf_counter() - t0
        c_loss = ops.launch_counts()
        expect_counts(c_loss, f"{cfg.name} loss under scan_method={method!r}", **want)
        check(tuple(lg.shape) == (b, s, cfg.padded_vocab) and bool(lg.isfinite().all())
              and bool(torch.isfinite(total)) and float(parts["aux"]) > 0,
              f"{cfg.name} forward {method}: logits {tuple(lg.shape)} or loss {parts}")
        launched = _sum_counts(launched, c_fwd, c_loss)
        got = (lg, parts["ce"], parts["aux"], total)
        if ref is None:
            ref = got
        else:
            check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                  f"{cfg.name} forward {method}: logits, ce or aux differ from 'vector'")
        out[method] = {"launches_per_pass": {k: v for k, v in c_fwd.items() if v},
                       "forward_ms": fwd_s * 1e3, "loss_ms": loss_s * 1e3,
                       "tokens_per_s": b * s / fwd_s, "ce": float(parts["ce"]),
                       "aux": float(parts["aux"])}
        del lg, got
    del ref
    _free()
    out["bit_equal_across_methods"] = True
    out["dispatch"] = moe_dispatch_check(cfg, params, routing[0])
    return {"batch": b, "seq": s, **out, "counts": launched}


def continuous_moe(cfg, params) -> dict:
    """``ContinuousEngine`` (greedy) on ``cfg`` under ``scan_method="kernel"`` and
    ``MOE_TRACE``: a warm-up run under ``DenseReplay`` (every decode step's logits
    bit-equal to the dense replay), then the timed run with the counters zeroed
    just before: one B9 a MoE layer in each prefill and each decode step run."""
    kcfg = dataclasses.replace(cfg, scan_method="kernel")
    trace = poisson_trace(vocab_size=cfg.vocab_size, **MOE_TRACE)
    eng = ContinuousEngine(kcfg, params, sampler="greedy", **MOE_CONTINUOUS)
    per_alloc = alloc_launches(eng)
    with DenseReplay(eng) as rep:
        first = eng.run(trace)
    replay = rep.result()
    check(replay["bit_equal"] and replay["row_steps"] > 0,
          f"{cfg.name} continuous: paged decode differs from its dense replay: {replay}")
    probe = TickProbe(eng, profile=-1)
    probe.count = False
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = eng.run(trace)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps_run = len(probe.ms) * eng.tick_tokens
    layers = cfg.n_layers - cfg.moe.first_k_dense
    expect_counts(counts, f"{cfg.name} continuous", **_sum_counts(
        {"seg_scan": layers * (len(trace) + steps_run)},
        {k: v * eng.alloc.calls for k, v in per_alloc.items()}))
    check(_same_run(first, res), f"{cfg.name} continuous: two runs of the trace differ")
    st = res["stats"]
    return {"geometry": MOE_CONTINUOUS, "trace": MOE_TRACE, "dense_replay": replay,
            "seconds": wall, "tokens_per_s": st["total_tokens"] / wall, **st,
            "decode_ticks": len(probe.ms), "ms_per_tick": float(np.mean(probe.ms)),
            "decode_steps_run": steps_run, "launches": {k: v for k, v in counts.items() if v},
            "counts": counts}


def gemma2_window_check(cfg, params, gen) -> dict:
    """A local layer's ``attn_decode`` (scalar and per-row positions) and
    ``attn_decode_paged`` at a position past the window: the same bits after every
    cache entry outside the window (before it, and after the position) is
    overwritten with random values; paged equal to dense; without the window, not."""
    p = _first(params["stack"]["sub0"]["attn"])
    w, b, ps = cfg.local_window, 2, 16
    t = GEMMA["prompt"] + GEMMA["new"]
    pos = t - 3
    kh, hd, cdt = cfg.n_kv_heads, cfg.head_dim_, torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(cdt)

    x, k, v = rnd(b, 1, cfg.d_model), rnd(b, t, kh, hd), rnd(b, t, kh, hd)
    outside = torch.ones(t, dtype=torch.bool, device=DEV)
    outside[pos - w + 1:pos + 1] = False
    nblk = t // ps
    perm = torch.randperm(nblk * b, generator=gen, device=DEV) + 1    # page 0: scratch
    table = perm.reshape(b, nblk).to(torch.int32)

    def paged(kk, vv):
        pool_k = torch.zeros((nblk * b + 1, ps, kh, hd), dtype=cdt, device=DEV)
        pool_v = torch.zeros_like(pool_k)
        pool_k[table.to(torch.int64)] = kk.reshape(b, nblk, ps, kh, hd)
        pool_v[table.to(torch.int64)] = vv.reshape(b, nblk, ps, kh, hd)
        return {"k": pool_k, "v": pool_v, "pages": table}

    res = {}
    with torch.inference_mode():
        for name, at in (("scalar", pos), ("per_row", torch.full((b,), pos, device=DEV))):
            y0 = att_model.attn_decode(p, x, cfg, {"k": k.clone(), "v": v.clone()}, at,
                                       cdt=cdt, window=w)[0]
            k2, v2 = k.clone(), v.clone()
            k2[:, outside], v2[:, outside] = rnd(b, int(outside.sum()), kh, hd), \
                rnd(b, int(outside.sum()), kh, hd)
            y1 = att_model.attn_decode(p, x, cfg, {"k": k2, "v": v2}, at, cdt=cdt,
                                       window=w)[0]
            yp0 = att_model.attn_decode_paged(p, x, cfg, paged(k, v), at, cdt=cdt,
                                              window=w)[0]
            yp1 = att_model.attn_decode_paged(p, x, cfg, paged(k2, v2), at, cdt=cdt,
                                              window=w)[0]
            wide = att_model.attn_decode(p, x, cfg, {"k": k.clone(), "v": v.clone()}, at,
                                         cdt=cdt)[0]
            res[name] = {"dense_equal_after_overwrite": torch.equal(y0, y1),
                         "paged_equal_after_overwrite": torch.equal(yp0, yp1),
                         "paged_equal_dense": torch.equal(y0, yp0),
                         "no_window_max_abs_diff": float((wide - y0).abs().max())}
            check(res[name]["dense_equal_after_overwrite"]
                  and res[name]["paged_equal_after_overwrite"]
                  and res[name]["paged_equal_dense"]
                  and res[name]["no_window_max_abs_diff"] > 0,
                  f"gemma2 window ({name} position {pos}): {res[name]}")
    return {"window": w, "position": pos, "cache_len": t, "overwritten": int(outside.sum()),
            **res}


def phase_models(gen) -> dict:
    """deepseek-moe-16b (28 layers, bf16): serving under "kernel" and "blocked",
    forward / loss under three methods, the dispatch's routing checks and continuous
    batching; llama4-scout-17b-16e at full width, 2 of its 48 layers; qwen3-4b and
    gemma2-2b at full width and depth, gemma2's window bit for bit.  Returns the
    launches of the main-path runs (zeroed before and read after each)."""
    t_phase = time.perf_counter()
    launched, out = {k: 0 for k in ops.KERNELS}, {}
    torch.cuda.reset_peak_memory_stats(DEV)

    cfg = get_config("deepseek-moe-16b")
    params, init_s, n_params = _init_bf16(cfg, MODELS_SERVE["seed"])
    ds = {"n_layers": cfg.n_layers, "moe_layers": cfg.n_layers - cfg.moe.first_k_dense,
          "params": n_params, "init_s": init_s}
    for method in ("kernel", "blocked"):
        r = serve_family(cfg, params, gen, batch=MODELS_SERVE["batch"],
                         prompt=MODELS_SERVE["prompt"], new=MODELS_SERVE["new"],
                         method=method, per_pass=moe_per_pass(cfg, method))
        launched = _sum_counts(launched, r.pop("counts"))
        ds[f"serve_{method}"] = r
    fwd = forward_moe(cfg, params)
    launched = _sum_counts(launched, fwd.pop("counts"))
    ds["forward"] = fwd
    cont = continuous_moe(cfg, params)
    launched = _sum_counts(launched, cont.pop("counts"))
    ds["continuous"] = cont
    ds["peak_mem_gb"] = torch.cuda.max_memory_allocated(DEV) / 1e9
    out[cfg.name] = ds
    del params
    _free()

    full = get_config("llama4-scout-17b-16e")
    cfg = dataclasses.replace(full, n_layers=SCOUT["layers"])
    torch.cuda.reset_peak_memory_stats(DEV)
    params, init_s, n_params = _init_bf16(cfg, MODELS_SERVE["seed"])
    r = serve_family(cfg, params, gen, batch=SCOUT["batch"], prompt=SCOUT["prompt"],
                     new=SCOUT["new"], method="kernel", per_pass=moe_per_pass(cfg, "kernel"))
    launched = _sum_counts(launched, r.pop("counts"))
    out[cfg.name] = {"n_layers": cfg.n_layers,
                     "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"},
                     "params": n_params, "init_s": init_s, "serve_kernel": r,
                     "peak_mem_gb": torch.cuda.max_memory_allocated(DEV) / 1e9}
    del params
    _free()

    for arch, geo in (("qwen3-4b", QWEN), ("gemma2-2b", GEMMA)):
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats(DEV)
        params, init_s, n_params = _init_bf16(cfg, MODELS_SERVE["seed"])
        r = serve_family(cfg, params, gen, batch=geo["batch"], prompt=geo["prompt"],
                         new=geo["new"], method="auto", per_pass=lambda n: {})
        launched = _sum_counts(launched, r.pop("counts"))
        out[arch] = {"n_layers": cfg.n_layers, "params": n_params, "init_s": init_s,
                     "serve": r, "peak_mem_gb": torch.cuda.max_memory_allocated(DEV) / 1e9}
        if arch == "gemma2-2b":
            out[arch]["window_check"] = gemma2_window_check(cfg, params, gen)
        del params
        _free()
    emit({"phase": "models", **out, "launches": {k: v for k, v in launched.items() if v},
          "seconds": time.perf_counter() - t_phase})
    return launched


# ---------------------------------------------------------------------------
# families: xLSTM, MLA, enc-dec and the prefix-LM VLM at full width
# ---------------------------------------------------------------------------


def xlstm_per_pass(cfg, method: str, batch: int):
    """The launches of one xlstm pass over ``n`` tokens (``n // batch`` a row):
    each mLSTM layer's cell is two chunked SSD scans (numerator and normaliser),
    each one log-decay scan over rows of at most 128 (B1 on "kernel", B4 alone on
    "blocked": a row is one block) and, where the sequence spans more than one
    chunk of 128, one cross-chunk ``linear_scan`` on the column walk (B13, or
    B16: the chunk axis is one block); one chunk is a length-1 recurrence, which
    launches nothing.  The sLSTM layers launch nothing, and neither does a decode
    step (one token a row: a length-1 ``linear_scan`` of the state)."""
    layers = cfg.n_layers * (cfg.xlstm.slstm_every - 1) // cfg.xlstm.slstm_every
    scan, walk = {"kernel": ("scan_mm", "linrec_scan"),
                  "blocked": ("block_scan", "linrec_block_scan")}.get(method, (None, None))

    def per_pass(n):
        seq = n // batch
        if scan is None or seq == 1:
            return {}
        chunks = -(-seq // 128)
        check(chunks <= linrec_mm.LINREC_COLUMN_MAX, f"xlstm: {chunks} chunks")
        return {scan: 2 * layers, **({walk: 2 * layers} if chunks > 1 else {})}
    return per_pass


def xlstm_forward(cfg, params) -> dict:
    """xlstm-350m ``forward`` / ``loss`` on ``XLSTM_FORWARD``'s 4 x 2048 tokens under
    "vector", "kernel" and "blocked", each warmed up before its timed passes: the
    launches of each pass exact (:func:`xlstm_per_pass`), the ``ce`` of "kernel"
    and "blocked" within ``XLSTM_CE_TOL`` of "vector"'s; one sLSTM layer (a Python
    loop over time) timed alone on the same shape."""
    b, s = XLSTM_FORWARD["batch"], XLSTM_FORWARD["seq"]
    rng = np.random.default_rng(XLSTM_FORWARD["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    mask = torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.int32))
    batch = {"tokens": toks.to(DEV), "loss_mask": mask.to(DEV)}
    out, launched = {}, {k: 0 for k in ops.KERNELS}
    for method in ("vector", "kernel", "blocked"):
        model = build_model(dataclasses.replace(cfg, scan_method=method))
        want = xlstm_per_pass(cfg, method, b)(b * s)
        model.forward(params, batch)                                       # warm-up
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lg = model.forward(params, batch)
        sync()
        fwd_s = time.perf_counter() - t0
        c_fwd = ops.launch_counts()
        expect_counts(c_fwd, f"xlstm forward under scan_method={method!r}", **want)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        total, parts = model.loss(params, batch)
        sync()
        loss_s = time.perf_counter() - t0
        c_loss = ops.launch_counts()
        expect_counts(c_loss, f"xlstm loss under scan_method={method!r}", **want)
        check(tuple(lg.shape) == (b, s, cfg.padded_vocab) and bool(lg.isfinite().all())
              and bool(torch.isfinite(total)) and float(parts["aux"]) == 0.0,
              f"xlstm forward {method}: logits {tuple(lg.shape)} or loss {parts}")
        launched = _sum_counts(launched, c_fwd, c_loss)
        out[method] = {"launches_per_pass": {k: v for k, v in c_fwd.items() if v},
                       "forward_ms": fwd_s * 1e3, "loss_ms": loss_s * 1e3,
                       "tokens_per_s": b * s / fwd_s, "ce": float(parts["ce"])}
        del lg
    ce_v = out["vector"]["ce"]
    for method in ("kernel", "blocked"):
        dce = abs(out[method]["ce"] - ce_v)
        check(dce <= XLSTM_CE_TOL, f"xlstm ce under {method}: {out[method]['ce']} is {dce} "
              f"from vector's {ce_v}, beyond {XLSTM_CE_TOL}")
        out[method].update(ce_abs_diff_vs_vector=dce, ce_tol=XLSTM_CE_TOL)
    layers = cfg.n_layers // cfg.xlstm.slstm_every
    p = _first(params["stack"][f"sub{cfg.xlstm.slstm_every - 1}"]["mixer"])
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(DEV).manual_seed(
        FAMILY_SEED), device=DEV).to(torch.bfloat16)
    with torch.inference_mode():
        xlstm_model.slstm_block(p, x[:, :8], cfg, cdt=torch.bfloat16)     # warm-up
        sync()
        t0 = time.perf_counter()
        xlstm_model.slstm_block(p, x, cfg, cdt=torch.bfloat16)
        sync()
    slstm_ms = (time.perf_counter() - t0) * 1e3
    _free()
    return {"batch": b, "seq": s, **out, "slstm_layer_ms": slstm_ms, "slstm_layers": layers,
            "slstm_layers_ms": slstm_ms * layers, "counts": launched,
            "tokens": batch["tokens"]}


def mlstm_cell_check(cfg, params, tokens) -> dict:
    """One mLSTM layer's real inputs (layer 0, the forward's tokens, fp32 at full
    width, 4 x 2048 x 4 heads of 512), under "kernel" (2 B1 + 2 B13) and "blocked"
    (2 B4 + 2 B16): ``mlstm_chunked`` and each of its two ``ssd_scan`` outputs within
    ``SSD_REL``·max|y| of ``ssd_scan_ref`` in fp64; the cell's ``h`` held to
    ``mlstm_ref`` in fp64 within the bound those two limits give, element by
    element: ``|Δh| <= (|Δnum| + |h|·|Δden|) / (|den| + 1e-6)`` with ``|Δnum|``,
    ``|Δden|`` at their limits.  Then B13's and B16's column walks at the
    numerator's cross-chunk states."""
    layer = {k: (v[0].float() if not isinstance(v, dict) else {"g": v["g"][0].float()})
             for k, v in params["stack"]["sub0"]["mixer"].items()}
    cdt = torch.float32
    res = {}
    with torch.inference_mode():
        emb = torch.nn.functional.embedding(tokens.long(), params["embed"]["embed"]).float()
        x = rmsnorm({"g": params["stack"]["sub0"]["norm"]["g"][0]}, emb, cfg.norm_eps)
        q, k, v, i_pre, f_pre, _, _, _ = xlstm_model._mlstm_qkvif(layer, x, cfg, cdt)
        del emb, x
        f_log, gain, qs = ssd_core._mlstm_gates(q, i_pre, f_pre, torch.float32)
        scans = {"numerator": (v * gain[..., None], f_log, k, qs),
                 "normaliser": (gain[..., None], f_log, k, qs)}
        ref = {name: ssd_scan_ref(*(t.double() for t in args)) for name, args in scans.items()}
        top = {name: float(r.abs().max()) for name, r in ref.items()}
        den = ref["normaliser"][..., 0]
        h64 = ssd_core.mlstm_ref(q.double(), k.double(), v.double(), i_pre.double(),
                                 f_pre.double())
        limit = (SSD_REL * top["numerator"] + h64.abs() * SSD_REL * top["normaliser"]) / \
            (torch.abs(den) + 1e-6)[..., None]
        for method, want in (("kernel", dict(scan_mm=2, linrec_scan=2)),
                             ("blocked", dict(block_scan=2, linrec_block_scan=2))):
            ops.reset_launch_counts()
            h = ssd_core.mlstm_chunked(q, k, v, i_pre, f_pre, chunk=128, scan_method=method)
            sync()
            expect_counts(ops.launch_counts(), f"mlstm_chunked on {method!r}", **want)
            r = {}
            for name, args in scans.items():
                y = ssd_scan(*args, chunk=128, scan_method=method)
                err = float((y.double() - ref[name]).abs().max())
                check(err <= SSD_REL * top[name], f"mLSTM {name} scan on {method!r}: {err} "
                      f"from fp64, beyond {SSD_REL} x {top[name]}")
                r[name] = {"max_abs_err": err, "max_abs": top[name]}
                del y
            dh = (h.double() - h64).abs()
            check(bool((dh <= limit).all()), f"mLSTM cell on {method!r}: "
                  f"{int((dh > limit).sum())} elements beyond the bound its scans give "
                  f"(max |dh| {float(dh.max())})")
            r.update(cell_max_abs_err=float(dh.max()),
                     cell_max_err_over_bound=float((dh / limit).max()))
            res[method] = r
            del h, dh
        shape = [q.shape[0], q.shape[1] // 128, q.shape[2], q.shape[3], v.shape[3]]
        res.update(cell_max_abs=float(h64.abs().max()), min_abs_den=float(den.abs().min()),
                   cross_chunk_state=shape,
                   column_walk_columns_per_batch_head=q.shape[3] * v.shape[3])
    del q, k, v, i_pre, f_pre, f_log, gain, qs, scans, ref, den, h64, limit
    _free()
    for method, key, name in (("kernel", "linrec_scan", "b13_column_walk"),
                              ("blocked", "linrec_block_scan", "b16_column_walk")):
        res[name] = xlstm_column_walk(shape, method, key)
    return res


def xlstm_column_walk(shape, method: str, key: str) -> dict:
    """The column walk of ``method`` (B13 on "kernel", B16 on "blocked") at the
    numerator's cross-chunk states (B, S/128, H, hd, hd), fp32, a decay shared over
    each (hd, hd) state, as ``ssd_scan`` calls it: one launch, equal to its plain
    version within 2^-22·max|y|, its eager ms beside its bytes bound (the states
    read once, the result written once) and the plain version's ms."""
    g = torch.Generator(DEV).manual_seed(FAMILY_SEED)
    a = torch.exp(-torch.rand((*shape[:3], 1, 1), generator=g, device=DEV))
    bb = torch.randn(shape, generator=g, device=DEV)
    tile = min(128, max(2, shape[1]))

    def run():
        return linear_scan(a, bb, axis=1, method=method, tile_s=tile)

    ops.reset_launch_counts()
    y = run()
    sync()
    expect_counts(ops.launch_counts(), f"xlstm column walk on {method!r}", **{key: 1})
    plain = linrec_mm.linrec_columns_plain(a, bb, 1)
    err = float((y - plain).abs().max())
    check(err <= 2.0 ** -22 * float(plain.abs().max()),
          f"xlstm column walk on {method!r} differs from its plain version by {err}")
    ms, plain_ms = paired_ms(run, lambda: linrec_mm.linrec_columns_plain(a, bb, 1), 10)
    bound_ms, by = bound(2 * bb.numel() * 4 + a.numel() * 4)
    del a, bb, y, plain
    _free()
    return {"shape": list(shape), "columns": math.prod(shape) // math.prod(shape[:2]),
            "max_abs_err_vs_plain": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by}


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_clone_tree(v) for v in t)
    return t.clone() if isinstance(t, torch.Tensor) else t


# faults planted in the mLSTM layers' prefill state before the first decode step:
# the running max not carried (the state kept, its shift lost), and one step's
# forget gate 1% too small on every head
XLSTM_FAULTS = {
    "running_max_not_carried": lambda c: {**c, "m": torch.zeros_like(c["m"])},
    "forget_gate_1pct_short": lambda c: {**c, "c": c["c"] * 0.99, "n": c["n"] * 0.99},
}


def _xlstm_decode(kcfg, seed: int, faults: bool) -> dict:
    """fp32 under "kernel", weights from ``seed``: a prefill of ``XLSTM_DECODE``'s
    4 x 128 prompt tokens and 8 greedy decode steps, each step's logits against the
    forward over the same 136 tokens (the prompt and the 8 it chose).  With
    ``faults``, each of ``XLSTM_FAULTS`` planted in a copy of the prefill's caches
    (the decode step updates them in place), the same 8 tokens fed."""
    b, p, n = XLSTM_DECODE["batch"], XLSTM_DECODE["prompt"], XLSTM_DECODE["steps"]
    v = kcfg.vocab_size
    model = build_model(kcfg)
    params = model.init(seed, device=DEV, dtype=torch.float32)
    toks = torch.randint(0, v, (b, p), generator=torch.Generator(DEV).manual_seed(seed + 1),
                         device=DEV)
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": toks}, cache_len=p + n)
        same = model.forward(params, {"tokens": toks})[:, -1, :v]
        kept = _clone_tree(caches) if faults else None
        steps = [lg]
        for i in range(n):
            toks = torch.cat([toks, torch.argmax(lg, -1)[:, None]], dim=1)
            lg, caches = model.decode_step(params, toks[:, -1:], caches, p + i)
            steps.append(lg)
        full = model.forward(params, {"tokens": toks})[..., :v]
        res = {"max_abs_err_by_step": [float((lg[:, :v] - full[:, p - 1 + i]).abs().max())
                                       for i, lg in enumerate(steps)],
               "prefill_vs_forward_same_tokens": float((steps[0][:, :v] - same).abs().max()),
               "noncausal_drift_at_last_prompt_row": float((same - full[:, p - 1]).abs().max()),
               "max_abs_logit": float(full.abs().max())}
        for name, fault in (XLSTM_FAULTS.items() if faults else ()):
            c = _clone_tree(kept)
            c["stack"] = {k: fault(sub) if "m" in sub else sub for k, sub in c["stack"].items()}
            errs = []
            for i in range(n):
                lg, c = model.decode_step(params, toks[:, p + i:p + i + 1], c, p + i)
                errs.append(float((lg[:, :v] - full[:, p + i]).abs().max()))
            res[f"fault_{name}"] = max(errs)
    del params, caches, full, same, kept
    _free()
    return res


def xlstm_decode_check(cfg) -> dict:
    """fp32 prefill + 8 greedy decode steps against the forward over the same tokens
    (:func:`_xlstm_decode`).  The chunked pass shifts the cell by the sequence's max
    input gate, the replay and the steps by the running max; the shift cancels but
    for the cell's ``MLSTM_EPS``'s share of the small normalisers.

    At full width on ``XLSTM_DECODE["layers"]`` layers (3 mLSTM + 1 sLSTM), for each
    of ``XLSTM_DECODE["seeds"]``: every step within ``XLSTM_DECODE_TOL``, and, on the
    first seed, each planted fault above it.  At full depth the random 24-layer
    stack amplifies that share past use (even the forward over 128 tokens and over
    136 differ at row 127: ``noncausal_drift_at_last_prompt_row``), so there the
    distances are printed.  In both, the prefill is held within
    ``XLSTM_PREFILL_TOL`` of the forward over the same 128 tokens."""
    kcfg = dataclasses.replace(cfg, scan_method="kernel", dtype="float32")
    cut = dataclasses.replace(kcfg, n_layers=XLSTM_DECODE["layers"])
    seeds = XLSTM_DECODE["seeds"]
    runs = {f"cut_seed{s}": _xlstm_decode(cut, s, s == seeds[0]) for s in seeds}
    runs["full_depth"] = _xlstm_decode(kcfg, seeds[0], False)
    for name, r in runs.items():
        check(r["prefill_vs_forward_same_tokens"] <= XLSTM_PREFILL_TOL,
              f"xlstm {name}: prefill vs the forward over the same "
              f"{XLSTM_DECODE['prompt']} tokens: {r['prefill_vs_forward_same_tokens']}")
    sound = {name: max(r["max_abs_err_by_step"]) for name, r in runs.items()
             if name != "full_depth"}
    planted = {k[6:]: val for k, val in runs[f"cut_seed{seeds[0]}"].items()
               if k.startswith("fault_")}
    check(max(sound.values()) <= XLSTM_DECODE_TOL,
          f"xlstm fp32 prefill + decode vs forward at {cut.n_layers} layers: {sound}, "
          f"beyond {XLSTM_DECODE_TOL}")
    check(min(planted.values()) > XLSTM_DECODE_TOL,
          f"xlstm decode check is blind to a planted fault: {planted} within "
          f"{XLSTM_DECODE_TOL}")
    return {"batch": XLSTM_DECODE["batch"], "prompt": XLSTM_DECODE["prompt"],
            "decode_steps": XLSTM_DECODE["steps"], "cut_layers": cut.n_layers,
            "tol": XLSTM_DECODE_TOL, "prefill_tol": XLSTM_PREFILL_TOL,
            "sound_max_by_seed": sound, "planted_fault_max": planted, **runs}


def phase_xlstm(gen) -> tuple:
    """xlstm-350m (arXiv:2405.04517) at full size: 24 layers, 18 mLSTM and 6 sLSTM."""
    cfg = get_config("xlstm-350m")
    torch.cuda.reset_peak_memory_stats(DEV)
    params, init_s, n_params = _init_bf16(cfg, FAMILY_SEED)
    res = {"n_layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "mlstm_head_dim": int(cfg.xlstm.proj_factor * cfg.d_model) // cfg.xlstm.n_heads}
    fwd = xlstm_forward(cfg, params)
    launched, tokens = fwd.pop("counts"), fwd.pop("tokens")
    res["forward"] = fwd
    res["mlstm_cell"] = mlstm_cell_check(cfg, params, tokens)
    for method in ("kernel", "blocked"):
        r = serve_family(cfg, params, gen, method=method,
                         per_pass=xlstm_per_pass(cfg, method, FAMILY_SERVE["batch"]),
                         **FAMILY_SERVE)
        launched = _sum_counts(launched, r.pop("counts"))
        res[f"serve_{method}"] = r
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(DEV) / 1e9
    del params
    _free()
    res["fp32_prefill_decode_vs_forward"] = xlstm_decode_check(cfg)
    return res, launched


def mla_check(cfg, params, gen) -> dict:
    """Layer 0's MLA in fp32 on random inputs (4 x 129): ``mla_decode`` (absorbed) at
    position ``MLA_POS`` after a prefill of ``MLA_POS`` tokens against the last row
    of ``mla_full`` (expanded) over all 129, within ``MLA_TOL``·max|row|."""
    p = {k: (v[0].float() if not isinstance(v, dict) else {"g": v["g"][0].float()})
         for k, v in params["stack"]["sub0"]["attn"].items()}
    b, s = FAMILY_SERVE["batch"], MLA_POS
    x = torch.randn((b, s + 1, cfg.d_model), generator=gen, device=DEV)
    pos = torch.arange(s + 1, dtype=torch.int32, device=DEV)[None]
    with torch.inference_mode():
        _, cache = att_model.mla_full(p, x[:, :s], cfg, positions=pos[:, :s],
                                      cdt=torch.float32, return_cache=True, cache_len=s + 1)
        dec = att_model.mla_decode(p, x[:, s:], cfg, cache, s, cdt=torch.float32)[0][:, 0]
        row = att_model.mla_full(p, x, cfg, positions=pos, cdt=torch.float32)[:, s]
    err, top = float((dec - row).abs().max()), float(row.abs().max())
    check(err <= MLA_TOL * top, f"MLA absorbed decode at {s}: {err} from the expanded "
          f"row, beyond {MLA_TOL} x {top}")
    m = cfg.mla
    per_layer_latent = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    per_layer_kv = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 2
    return {"position": s, "max_abs_err": err, "max_abs": top, "tol": MLA_TOL,
            "latent_cache_bytes_per_token": per_layer_latent * cfg.n_layers,
            "expanded_kv_bytes_per_token": per_layer_kv * cfg.n_layers}


def whisper_check(cfg, params, gen) -> dict:
    """whisper-small's encoder timed alone, the ``xkv`` cache bit-equal after 32
    greedy decode steps, and one ``forward`` / ``loss`` on 4 x 448 decoder tokens."""
    b, p, n = WHISPER["batch"], WHISPER["prompt"], WHISPER["new"]
    enc = torch.randn((b, cfg.enc_len, cfg.d_model), generator=gen, device=DEV
                      ).to(torch.bfloat16)
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, WHISPER["forward_len"]), generator=gen,
                         device=DEV)
    with torch.inference_mode():
        model._encode(params, enc)
        enc_ms = cuda_ms(lambda: model._encode(params, enc), 5)
        lg, caches = model.prefill(params, {"tokens": toks[:, :p], "enc_embed": enc},
                                   cache_len=p + n)
        xkv = {k: v.clone() for k, v in caches["stack"]["sub0"]["xkv"].items()}
        tok = torch.argmax(lg, -1)[:, None]
        for i in range(n):
            lg, caches = model.decode_step(params, tok, caches, p + i)
            tok = torch.argmax(lg, -1)[:, None]
        same = all(torch.equal(caches["stack"]["sub0"]["xkv"][k], v) for k, v in xkv.items())
        check(same, "whisper: the cross KV cache changed during decode")
        batch = {"tokens": toks, "enc_embed": enc}
        logits = model.forward(params, batch)
        total, parts = model.loss(params, batch)
    check(tuple(logits.shape) == (b, WHISPER["forward_len"], cfg.padded_vocab)
          and bool(logits.isfinite().all()) and bool(torch.isfinite(total)),
          f"whisper forward: logits {tuple(logits.shape)} or loss {parts}")
    return {"encoder_ms": enc_ms, "enc_len": cfg.enc_len, "xkv_bit_equal_after_decode": same,
            "xkv_shape": list(xkv["k"].shape), "decode_steps_checked": n,
            "forward_tokens": [b, WHISPER["forward_len"]], "ce": float(parts["ce"])}


def prefix_mask_check(cfg, params, gen) -> dict:
    """paligemma's layer-0 ``attn_full`` on the card (bf16 weights, random bf16
    input over 256 image + 16 text positions) under ``prefix_len = 256``: changing
    the last text token leaves every image position's output bit-equal; changing
    the last image token changes the first image position's output."""
    p = _first(params["stack"]["sub0"]["attn"])
    pl = cfg.n_img_tokens
    x = torch.randn((2, pl + 16, cfg.d_model), generator=gen, device=DEV).to(torch.bfloat16)
    pos = torch.arange(pl + 16, dtype=torch.int32, device=DEV)[None]

    def run(xx):
        return att_model.attn_full(p, xx, cfg, positions=pos, cdt=torch.bfloat16,
                                   prefix_len=pl)

    with torch.inference_mode():
        y = run(x)
        xt, xi = x.clone(), x.clone()
        xt[:, -1] = torch.randn((2, cfg.d_model), generator=gen, device=DEV).to(x.dtype)
        xi[:, pl - 1] = torch.randn((2, cfg.d_model), generator=gen, device=DEV).to(x.dtype)
        yt, yi = run(xt), run(xi)
    res = {"image_outputs_bit_equal_after_text_change": torch.equal(yt[:, :pl], y[:, :pl]),
           "last_text_output_changed": not torch.equal(yt[:, -1], y[:, -1]),
           "first_image_output_changed_by_last_image_token":
               float((yi[:, 0] - y[:, 0]).abs().max())}
    check(res["image_outputs_bit_equal_after_text_change"] and res["last_text_output_changed"]
          and res["first_image_output_changed_by_last_image_token"] > 0,
          f"paligemma prefix mask: {res}")
    return res


def vlm_loss_check(cfg, params, img, gen) -> dict:
    """paligemma's ``loss`` over 4 x 128 text tokens after the image: its ``ce`` is
    the text positions' alone, within ``CE_SLACK`` of the ``ce`` of the forward's
    logits sliced past the image."""
    b = FAMILY_SERVE["batch"]
    toks = torch.randint(0, cfg.vocab_size, (b, FAMILY_SERVE["prompt"]), generator=gen,
                         device=DEV)
    batch = {"tokens": toks, "img_embed": img}
    model = build_model(cfg)
    with torch.inference_mode():
        logits = model.forward(params, batch)
        _, parts = model.loss(params, batch)
        lg = logits[:, cfg.n_img_tokens:-1]
        nll = torch.logsumexp(lg, -1) - torch.gather(lg, -1, toks[:, 1:, None].long())[..., 0]
        ce_text = float(nll.mean())
    ce = float(parts["ce"])
    check(tuple(logits.shape)[1] == cfg.n_img_tokens + toks.shape[1]
          and abs(ce - ce_text) <= CE_SLACK * abs(ce_text),
          f"paligemma loss {ce} is not the text positions' {ce_text}")
    return {"ce": ce, "ce_text_positions": ce_text, "logit_positions": logits.shape[1]}


def phase_families(gen) -> dict:
    """xlstm-350m, minicpm3-4b, whisper-small and paligemma-3b at full width and
    depth, bf16 weights from ``FAMILY_SEED``, each freed before the next.  Returns
    the launches of the main-path runs (zeroed before and read after each)."""
    t_phase = time.perf_counter()
    out = {}
    out["xlstm-350m"], launched = phase_xlstm(gen)

    for arch in ("minicpm3-4b", "whisper-small", "paligemma-3b"):
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats(DEV)
        params, init_s, n_params = _init_bf16(cfg, FAMILY_SEED)
        res = {"n_layers": cfg.n_layers, "params": n_params, "init_s": init_s}
        geo, extra = dict(FAMILY_SERVE), {}
        if arch == "whisper-small":
            geo.update(prompt=WHISPER["prompt"], new=WHISPER["new"])
            extra["enc_embed"] = torch.randn((geo["batch"], cfg.enc_len, cfg.d_model),
                                             generator=gen, device=DEV).to(torch.bfloat16)
            res["n_enc_layers"] = cfg.n_enc_layers
        if arch == "paligemma-3b":
            extra["img_embed"] = torch.randn((geo["batch"], cfg.n_img_tokens, cfg.d_model),
                                             generator=gen, device=DEV).to(torch.bfloat16)
        r = serve_family(cfg, params, gen, method="auto", per_pass=lambda n: {},
                         extra=extra, **geo)
        launched = _sum_counts(launched, r.pop("counts"))
        res["serve"] = r
        if arch == "minicpm3-4b":
            res["mla"] = mla_check(cfg, params, gen)
        elif arch == "whisper-small":
            res["encdec"] = whisper_check(cfg, params, gen)
        else:
            res["prefix_mask"] = prefix_mask_check(cfg, params, gen)
            res["loss"] = vlm_loss_check(cfg, params, extra["img_embed"], gen)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(DEV) / 1e9
        out[arch] = res
        del params, extra
        _free()
    emit({"phase": "families", **out, "launches": {k: v for k, v in launched.items() if v},
          "seconds": time.perf_counter() - t_phase})
    return launched


# ---------------------------------------------------------------------------
# B7h: the radix pass that exports its histogram
# ---------------------------------------------------------------------------


def _b7h_hold(work, perm, shift, bits, tag) -> int:
    """One B7h pass against its plain version and a bincount of the digits."""
    kw, kp, kc = split_mm.radix_pass_multibit(work, perm, shift=shift, pass_bits=bits,
                                              with_counts=True)
    pw, pp, pc = split_mm.radix_pass_plain(work, perm, shift=shift, pass_bits=bits,
                                           with_counts=True)
    check(torch.equal(kw, pw) and torch.equal(kp, pp) and torch.equal(kc, pc),
          f"B7h {tag} shift={shift}: != plain version")
    digits = (work.long() >> shift) & ((1 << bits) - 1)
    rows = torch.arange(work.shape[0], device=DEV)[:, None] << bits
    hist = torch.bincount((digits + rows).reshape(-1), minlength=work.shape[0] << bits)
    check(torch.equal(kc.long(), hist.reshape(work.shape[0], -1)),
          f"B7h {tag} shift={shift}: counts != bincount of the digits")
    return max(int((kw.long() - pw.long()).abs().max()), int((kp - pp).abs().max()),
               int((kc - pc).abs().max()))


def phase_b7h(gen):
    """B7h at (4, 2^22) int32 keys: every shift of the 8 radix-16 passes, chained into
    a sort held against a stable ``torch.sort``; a ragged row, whose counts must be
    its own keys' (the kernel masks the row's end, nothing is padded); 16-bit keys."""
    b, n = B7H_SHAPE
    keys = torch.randint(-(1 << 31), (1 << 31) - 1, B7H_SHAPE, generator=gen, device=DEV,
                         dtype=torch.int64).to(torch.int32)
    keys[:, 1000:2000] = keys[:, :1000]                       # duplicate keys: stability
    perm = torch.arange(n, dtype=torch.int32, device=DEV).expand(b, n).contiguous()
    worst, work, p = 0, keys, perm
    for shift in range(0, 32, 4):
        worst = max(worst, _b7h_hold(work, p, shift, 4, "int32"))
        work, p, _ = split_mm.radix_pass_multibit(work, p, shift=shift, pass_bits=4,
                                                  with_counts=True)
    lib_v, lib_i = torch.sort(keys.long() & 0xFFFFFFFF, dim=-1, stable=True)
    check(torch.equal(work.long() & 0xFFFFFFFF, lib_v) and torch.equal(p.long(), lib_i),
          "B7h: the 8-pass chain is not a stable sort of the unsigned keys")
    m = n - 12345                                              # a ragged row end
    rag = keys[:, :m].contiguous()
    rperm = perm[:, :m].contiguous()
    for shift in (0, 28):
        worst = max(worst, _b7h_hold(rag, rperm, shift, 4, "ragged"))
        _, _, c = split_mm.radix_pass_multibit(rag, rperm, shift=shift, pass_bits=4,
                                               with_counts=True)
        check(bool((c.sum(-1) == m).all()), "B7h ragged: counts != the row's own keys")
    k16 = (keys & 0xFFFF).to(torch.int16)
    for shift in range(0, 16, 4):
        worst = max(worst, _b7h_hold(k16, perm, shift, 4, "int16"))
    edges = radix_tile_edges(gen, with_counts=True)
    worst = max(worst, edges["tile_edge_max_abs_err"])
    sync()
    emit({"phase": "b7h", "shape": list(B7H_SHAPE), "passes_int32": 8, "ragged_n": m,
          "passes_int16": 4, **edges, "exact": True, "max_abs_err_vs_plain": worst})
    return worst


# ---------------------------------------------------------------------------
# dist: the distributed operators in gloo worlds on the one card
# ---------------------------------------------------------------------------


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


def dist_rank(shape, vocab, seed, time_reps):
    """One rank of the ``dist`` phase (run by ``repro_torch.launch.world``).

    Every rank draws the same global inputs from ``seed`` on the card and takes its
    shard; each checked call runs with the launch and collective counters zeroed
    just before and read just after, and its launches and collectives must be
    exact.  The references are the single-device operators on the whole input, on
    this rank."""
    warnings.simplefilter("error", AutotuneFallbackWarning)
    d, me = comm.axis_size(), comm.axis_index()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, n = shape
    L = comm.shard_len(n, d)
    lo, hi = me * L, min((me + 1) * L, n)
    res = {"rank": me, "world": d, "transport": comm.transport(None, DEV), "calls": {},
           "tokens": [], "max_ulp": {}}

    def main_call(name, fn, want, model):
        sync()
        ops.reset_launch_counts()
        comm.reset_comm_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches, coll = ops.launch_counts(), comm.comm_counts()
        expect_counts(launches, f"{name} on rank {me} of {d}", **want)
        check(_nonzero(coll["calls"]) == model["counts_by_kind"]
              and _nonzero(coll["bytes"]) == model["bytes_by_kind"],
              f"{name} on rank {me} of {d}: collectives {coll} != the model {model}")
        res["calls"][name] = {"launches": launches, "collectives": coll, "ms": ms}
        return out

    # --- sorts and top-k: bit-equal to the local kernel sort of the whole rows ---
    x = torch.randn(shape, generator=gen, device=DEV)
    x[:, 1000:2000] = x[:, :1000]                          # ties inside a shard
    x[:, L - 500:L + 500] = x[:, 3000:4000]                # and across a shard boundary
    xb = x.to(torch.bfloat16)
    sort_model = {dt: modeled_dist_traffic("dist_sort", d=d, n=n, batch=b, dtype=dt)
                  for dt in ("float32", "bfloat16")}
    v, i = main_call("dist_sort_f32", lambda: dist_sort(x[:, lo:hi], n, method="kernel"),
                     {"radix_pass_hist": 8}, sort_model["float32"])
    rv, ri = radix_sort(x, method="kernel")
    check(torch.equal(v, rv[:, lo:hi]) and torch.equal(i, ri[:, lo:hi]),
          f"dist_sort fp32 on rank {me} of {d} != the local kernel sort")
    k = 1000
    v, i = main_call("dist_topk_f32", lambda: dist_topk(x[:, lo:hi], k, n, method="kernel"),
                     {"radix_pass_hist": 8}, sort_model["float32"])
    rv, ri = radix_sort(x, descending=True, method="kernel")
    keep = max(0, min(hi - lo, k - lo))
    check(torch.equal(v, rv[:, lo:lo + keep]) and torch.equal(i, ri[:, lo:lo + keep]),
          f"dist_topk on rank {me} of {d} != the local kernel sort's top {k}")
    v, i = main_call("dist_sort_bf16_desc",
                     lambda: dist_sort(xb[:, lo:hi], n, descending=True, method="kernel"),
                     {"radix_pass_hist": 4}, sort_model["bfloat16"])
    rv, ri = radix_sort(xb, descending=True, method="kernel")
    check(torch.equal(v, rv[:, lo:hi]) and torch.equal(i, ri[:, lo:hi]),
          f"dist_sort bf16 on rank {me} of {d} != the local kernel sort")
    del rv, ri, v, i, xb
    times = []
    for _ in range(time_reps):
        sync()
        t0 = time.perf_counter()
        dist_sort(x[:, lo:hi], n, method="kernel")
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    res["dist_sort_f32_ms"] = times

    # --- top-p over the vocab shards: every token inside its row's window ---
    vl = comm.shard_len(vocab, d)
    vlo, vhi = me * vl, min((me + 1) * vl, vocab)
    topp_model = modeled_dist_traffic("dist_top_p_sample", d=d, n=vocab, batch=b)
    steps = []
    for sigma in (2.0, 8.0):
        logits = torch.randn((b, vocab), generator=gen, device=DEV) * sigma
        u = torch.rand((b, 1), generator=gen, device=DEV)
        tok = main_call(f"dist_top_p_sample_sigma{sigma:g}",
                        lambda: dist_top_p_sample(logits[:, vlo:vhi], vocab, p=0.9,
                                                  method="kernel", u=u),
                        {"radix_pass_hist": 4, "multi_split": 4, "scan_mm": 2}, topp_model)
        steps.append((logits, u, tok))
        res["tokens"].append(tok.cpu())
    res["top_p"] = hold_steps(steps, 0.9, "dist_top_p_sample")
    if d == 2:
        # the guards phase's sampler rows under nonfinite="sanitize": the poisoned rows
        # their greedy token, the others inside their window; the flags' all-reduce
        # and the greedy token's two beside the model's other collectives
        rows, gu = guard_rows(gen, vocab)
        tok = main_call("dist_top_p_sample_sanitize",
                        lambda: dist_top_p_sample(rows[:, vlo:vhi], vocab, p=0.9,
                                                  method="kernel", u=gu,
                                                  nonfinite="sanitize"),
                        {"radix_pass_hist": 4, "multi_split": 4, "scan_mm": 2},
                        modeled_dist_traffic("dist_top_p_sample", d=d, n=vocab, batch=b,
                                             nonfinite="sanitize"))
        greedy = greedy_tokens(rows)
        check(torch.equal(tok[2:].long(), greedy[2:]),
              f"dist_top_p_sample sanitize on rank {me}: poisoned rows drew "
              f"{tok[2:].tolist()}, not their greedy tokens {greedy[2:].tolist()}")
        res["top_p_sanitize"] = {"tokens": tok.tolist(), "greedy": greedy.tolist(),
                                 **hold_steps([(rows[:2], gu[:2], tok[:2])], 0.9,
                                              "dist_top_p_sample sanitize", masks=True)}
        res["tokens"].append(tok.cpu())
        del rows

    # --- mcscan: int8 exact, fp32 within the ulp limit of the fp64 scan ---
    xf = torch.randn(shape, generator=gen, device=DEV)
    x8 = torch.randint(-128, 128, shape, generator=gen, device=DEV).to(torch.int8)
    ref, scale = xf.double().cumsum(-1), xf.double().abs().cumsum(-1)
    ref8 = x8.long().cumsum(-1)
    scan_model = modeled_dist_traffic("mcscan", d=d, n=n, batch=b, itemsize=4)
    for method, want in (("kernel", {"scan_mm": 1}),
                         ("blocked", {"block_sums": 1, "block_scan": 1})):
        y = main_call(f"mcscan_f32_{method}", lambda: mcscan(xf[:, lo:hi], method=method),
                      want, scan_model)
        res["max_ulp"][f"mcscan_{method}"] = e = max_ulp_dev(y, ref[:, lo:hi],
                                                             scale[:, lo:hi])
        check(e <= B1_F32_ULP, f"mcscan({method}) on rank {me}: {e} ulp > {B1_F32_ULP}")
        y8 = main_call(f"mcscan_int8_{method}", lambda: mcscan(x8[:, lo:hi], method=method),
                       want, scan_model)
        check(torch.equal(y8.long(), ref8[:, lo:hi]), f"mcscan({method}) int8 not exact")
    del xf, x8, ref, scale, ref8

    # --- dist_linear_scan: integer-valued rows exact, random within the ulp limit ---
    rows = lin_inputs(gen, shape)
    a, bb = rows["random"]
    ref, scale = lin_ref64(a, bb), lin_ref64(a.abs(), bb.abs())
    ai, bi = rows["int"]
    refi = lin_ref64(ai, bi)
    lin_model = modeled_dist_traffic("dist_linear_scan", d=d, n=n, batch=b, itemsize=4)
    for method, want in (("kernel", {"linrec_scan": 2}),
                         ("blocked", {"linrec_summaries": 2, "linrec_block_scan": 2})):
        y = main_call(f"dist_linear_scan_{method}",
                      lambda: dist_linear_scan(a[:, lo:hi], bb[:, lo:hi], n, method=method),
                      want, lin_model)
        if method == "blocked":             # B15's walk in each B14 launch
            res["calls"][f"dist_linear_scan_{method}"]["fused_b14_b15"] = fused_walks(
                f"dist_linear_scan on rank {me} of {d}", 2, "linrec_summaries_carries")
        res["max_ulp"][f"dist_linear_scan_{method}"] = e = max_ulp_dev(
            y, ref[:, lo:hi], scale[:, lo:hi])
        check(e <= B1_F32_ULP, f"dist_linear_scan({method}) on rank {me}: {e} ulp")
        if d == 2 and method == "kernel":
            # the precision phase's distributed call: "highest"'s launches and bits
            yc = main_call("dist_linear_scan_compensated_kernel",
                           lambda: dist_linear_scan(a[:, lo:hi], bb[:, lo:hi], n,
                                                    method=method, precision="compensated"),
                           want, lin_model)
            res["max_ulp"]["dist_linear_scan_compensated_kernel"] = e = max_ulp_dev(
                yc, ref[:, lo:hi], scale[:, lo:hi])
            check(e <= ulp.ulp_bound("compensated", n) and torch.equal(yc, y),
                  f"dist_linear_scan(kernel, compensated) on rank {me}: {e} ulp, or not "
                  "highest's bits")
        yi = main_call(f"dist_linear_scan_int_{method}",
                       lambda: dist_linear_scan(ai[:, lo:hi], bi[:, lo:hi], n, method=method),
                       want, lin_model)
        check(torch.equal(yi.double(), refi[:, lo:hi]),
              f"dist_linear_scan({method}) integer-valued rows not exact")
    del rows, a, bb, ai, bi, ref, scale, refi

    # --- dist_segment_scan: int8 exact, fp32 within the ulp limit per segment ---
    off = seg_offsets(np.random.default_rng(SEG_SEED + 2), n)
    flags = boundary_flags(off, n)
    xs = _seg_inputs(gen, shape)
    refi, _ = seg_ref64(xs["int8"], flags)
    ref, scale = seg_ref64(xs["f32rand"], flags)
    seg_model = modeled_dist_traffic("dist_segment_scan", d=d, n=n, batch=b, itemsize=4)
    for method, want in (("kernel", {"seg_scan": 1}),
                         ("blocked", {"seg_summaries": 1, "seg_carry": 1,
                                      "seg_block_scan": 1})):
        y = main_call(f"dist_segment_scan_f32_{method}",
                      lambda: dist_segment_scan(xs["f32rand"][:, lo:hi], off, n,
                                                method=method),
                      want, seg_model)
        res["max_ulp"][f"dist_segment_scan_{method}"] = e = max_ulp_dev(
            y, ref[:, lo:hi], scale[:, lo:hi])
        check(e <= B1_F32_ULP, f"dist_segment_scan({method}) on rank {me}: {e} ulp")
        if d == 2 and method == "kernel":
            yc = main_call("dist_segment_scan_compensated_kernel",
                           lambda: dist_segment_scan(xs["f32rand"][:, lo:hi], off, n,
                                                     method=method, precision="compensated"),
                           want, seg_model)
            res["max_ulp"]["dist_segment_scan_compensated_kernel"] = e = max_ulp_dev(
                yc, ref[:, lo:hi], scale[:, lo:hi])
            check(e <= ulp.ulp_bound("compensated", n) and torch.equal(yc, y),
                  f"dist_segment_scan(kernel, compensated) on rank {me}: {e} ulp, or not "
                  "highest's bits")
        yi = main_call(f"dist_segment_scan_int8_{method}",
                       lambda: dist_segment_scan(xs["int8"][:, lo:hi], off, n, method=method),
                       want, seg_model)
        check(torch.equal(yi.double(), refi[:, lo:hi]),
              f"dist_segment_scan({method}) int8 not exact")
    res["segments"] = int(off.numel() - 1)
    return res


def _world_dir(name):
    path = os.path.join(ROOT, "build", "chip_smoke_worlds", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _free_card():
    gc.collect()
    torch.cuda.empty_cache()


def phase_dist():
    """The ``dist`` phase's worlds of 4 and of 2 ranks on the card.  Returns the
    kernels' launches summed over every rank's checked calls, dist_sort's ms, and
    the launches of each world (summed over its ranks)."""
    _free_card()
    launches, summary, sort_ms = collections.Counter(), {}, {}
    by_world = {}
    for d in DIST_WORLDS:
        t0 = time.perf_counter()
        ranks = run_world("chip_smoke:dist_rank", d,
                          dict(shape=DIST_SHAPE, vocab=VOCAB, seed=DIST_SEED, time_reps=2),
                          workdir=_world_dir(f"dist{d}"), timeout=DIST_TIMEOUT,
                          pythonpath=[ROOT])
        for r in ranks[1:]:
            check(all(torch.equal(a, t) for a, t in zip(ranks[0]["tokens"], r["tokens"])),
                  f"dist_top_p_sample: rank {r['rank']} of {d} drew other tokens than rank 0")
        by_world[d] = collections.Counter()
        for r in ranks:
            for call in r["calls"].values():
                by_world[d].update(call["launches"])
        launches.update(by_world[d])
        sort_ms[d] = min(min(r["dist_sort_f32_ms"]) for r in ranks)
        summary[d] = {
            "transport": ranks[0]["transport"], "seconds": time.perf_counter() - t0,
            "calls": {name: {"launches": _nonzero(c["launches"]),
                             "collectives": {k: _nonzero(v) for k, v in
                                             c["collectives"].items()},
                             "ms_rank0": c["ms"]}
                      for name, c in ranks[0]["calls"].items()},
            "max_ulp": {k: max(r["max_ulp"][k] for r in ranks) for k in ranks[0]["max_ulp"]},
            "top_p": ranks[0]["top_p"], "segments": ranks[0]["segments"],
            "top_p_sanitize": ranks[0].get("top_p_sanitize"),
            "dist_sort_f32_ms_per_rank": [r["dist_sort_f32_ms"] for r in ranks]}
    emit({"phase": "dist", "global_shape": list(DIST_SHAPE), "vocab": VOCAB,
          "worlds": summary})
    return {k: launches[k] for k in ops.KERNELS}, sort_ms, by_world


# ---------------------------------------------------------------------------
# serve_sharded: ServeEngine topp_sharded on llama3-8b, two ranks on the card
# ---------------------------------------------------------------------------


def serve_sharded_rank(seed, batch, prompt, new):
    """One rank of ``serve_sharded``: the whole model on this rank, the vocab's
    half sampled here (``dist_top_p_sample``, ``method="matmul"``)."""
    warnings.simplefilter("error", AutotuneFallbackWarning)
    me = comm.axis_index()
    cfg = get_config("llama3-8b")
    params = build_model(cfg).init(seed, device=DEV, dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)      # the same on every rank
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=DEV)
    uniforms = torch.rand((new, batch), generator=gen, device=DEV)
    inputs = {"tokens": prompts}
    eng = ServeEngine(cfg, params, mesh=dist.group.WORLD, max_len=prompt + new,
                      sampler="topp_sharded")
    eng.generate(inputs, 2, uniforms=uniforms[:2])                 # warm-up
    sync()
    ops.reset_launch_counts()
    comm.reset_comm_counts()
    toks, t_full = _timed_generate(eng, inputs, new, uniforms=uniforms)
    launches, coll = ops.launch_counts(), comm.comm_counts()
    expect_counts(launches, f"topp_sharded serving on rank {me}")  # matmul: no kernel
    step = modeled_dist_traffic("dist_top_p_sample", d=comm.axis_size(), n=cfg.padded_vocab,
                                batch=batch)
    check(_nonzero(coll["calls"]) == {k: new * v for k, v in step["counts_by_kind"].items()}
          and _nonzero(coll["bytes"]) == {k: new * v for k, v in
                                          step["bytes_by_kind"].items()},
          f"topp_sharded serving on rank {me}: collectives {coll} != {new} x {step}")
    _, t_one = _timed_generate(eng, inputs, 1, uniforms=uniforms[:1])
    sampled = check_sampled(eng, inputs, uniforms, toks, new)
    solo = ServeEngine(cfg, params, max_len=prompt + new, sampler="topp_scan")
    solo_toks = solo.generate(inputs, new, uniforms=uniforms)
    return {"rank": me, "tokens": toks.cpu(), "solo_tokens": solo_toks.cpu(),
            "launches": launches, "collectives": coll, "step_model": step,
            "generate_s": t_full, "prefill_plus_first_sample_ms": t_one * 1e3,
            "decode_step_ms": (t_full - t_one) / (new - 1) * 1e3, **sampled,
            "peak_mem_gb": torch.cuda.max_memory_allocated(DEV) / 1e9,
            "transport": comm.transport(None, DEV)}


def phase_serve_sharded():
    """``serve_sharded``: both ranks return one stream, inside the solo windows."""
    _free_card()
    cfg = SERVE_SHARDED
    t0 = time.perf_counter()
    ranks = run_world("chip_smoke:serve_sharded_rank", cfg["ranks"],
                      dict(seed=cfg["seed"], batch=cfg["batch"], prompt=cfg["prompt"],
                           new=cfg["new"]),
                      workdir=_world_dir("serve_sharded"), timeout=DIST_TIMEOUT,
                      pythonpath=[ROOT])
    toks = ranks[0]["tokens"]
    check(tuple(toks.shape) == (cfg["batch"], cfg["new"]) and toks.dtype == torch.int32,
          f"topp_sharded tokens have shape {tuple(toks.shape)}")
    for r in ranks[1:]:
        check(torch.equal(r["tokens"], toks), f"topp_sharded: rank {r['rank']}'s stream "
              "differs from rank 0's")
    r0 = ranks[0]
    emit({"phase": "serve_sharded", "arch": "llama3-8b", "ranks": cfg["ranks"],
          "dtype": "bfloat16", "batch": cfg["batch"], "prompt": cfg["prompt"],
          "new_tokens": cfg["new"], "transport": r0["transport"],
          "seconds": time.perf_counter() - t0,
          "decode_step_ms": [r["decode_step_ms"] for r in ranks],
          "prefill_plus_first_sample_ms": [r["prefill_plus_first_sample_ms"] for r in ranks],
          "collectives_per_step": r0["step_model"]["counts_by_kind"],
          "collective_bytes_per_step": r0["step_model"]["bytes_by_kind"],
          "collectives_of_the_run": {k: _nonzero(v) for k, v in r0["collectives"].items()},
          "stream_agreement_with_topp_scan": float((toks == r0["solo_tokens"]).float().mean()),
          "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
          **{k: r0[k] for k in ("steps_checked", "token_agreement_with_plain_sampler",
                                "rows_with_one_answer", "widest_window",
                                "plain_sampler_rows_in_window")}})
    return {k: sum(r["launches"][k] for r in ranks) for k in ops.KERNELS}


# ---------------------------------------------------------------------------
# mesh: data-parallel training and expert-parallel serving on grids of ranks
# ---------------------------------------------------------------------------

# train_dp: zamba2-1.2b at full width, its depth cut to a multiple of its
# shared-attention interval (6) so that two ranks fit the card (one rank at 38
# layers peaks at 46.1 GB); the fp32 check runs a shallower copy on one row a rank
MESH_TRAIN = dict(layers=12, batch=4, seq=2048, steps=5, seed=0, lr=1e-3, fp32_layers=6)
# the fp32 synced gradients against one rank's on the same rows: each leaf within
# MESH_GRAD_TOL of its largest magnitude (the CPU gradient tests' limit), the first
# loss within MESH_LOSS_RTOL; the planted fault (the gradient summed instead of
# averaged) reads 1.0
MESH_GRAD_TOL = 1e-4
MESH_LOSS_RTOL = 1e-5
COMPRESSED_TOL = 0.05               # compressed_grad_sync: JAX's limit, of max|mean|
# serve_ep: deepseek-moe-16b at full size, 32 of each layer's 64 experts a rank; the
# logits check runs the model at full width in fp32 on its first fp32_layers layers
MESH_SERVE = dict(batch=4, prompt=128, new=16, seed=0, fp32_layers=4)
# the fp32 prefill's logits against the one-rank model's, of max|logit|: the two
# parts of each MoE layer are summed in another order; the planted fault (the
# other rank's part dropped) reads O(1).  In bf16 at full depth the random stack
# amplifies the expert-parallel path's roundings (its gates and each rank's part
# rounded to bf16, the parts summed in bf16) past any use: an H100 (700 W) read
# 1.11 of max|logit|, and the CPU 0.66 on the SMOKE model at 28 layers (0.0073
# at 3, 0.0 in fp32); that reading is printed, not held
EP_LOGIT_TOL = 1e-4
MESH_TIMEOUT = 900


def _leaf_worst(got, ref) -> tuple:
    """The worst leaf's ``max|got - ref| / max|ref|`` over two flat dicts."""
    worst = (0.0, None)
    for k, r in ref.items():
        scale = float(r.abs().max()) or 1.0
        worst = max(worst, (float((got[k].to(r.device) - r).abs().max()) / scale, k))
    return worst


def _flat_tensors(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _crc(t) -> int:
    return zlib.crc32(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                      .numpy().tobytes())


def mesh_train_rank(layers, batch, seq, steps, seed, lr, fp32_layers, workdir):
    """One rank of ``train_dp``: zamba2-1.2b (``layers`` deep) data-parallel on a
    (2 data, 1 model) grid, then the fp32 check's gradients and checkpoint."""
    warnings.simplefilter("error", AutotuneFallbackWarning)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = Grid((2, 1), ("data", "model"))
    me = comm.axis_index()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=layers)
    opt = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    tr = Trainer(cfg, opt, mesh=grid, device=DEV)
    state = tr.init_state(seed)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    src = SyntheticLM(cfg.vocab_size, seq, batch)
    b0 = {k: torch.as_tensor(v).to(DEV) for k, v in src.batch_at(0).items()}

    # the int8 sync on step 1's real gradients against their fp32 mean
    _, _, local = tr.grads(state["params"], b0, sync=False)
    _, _, synced = tr.grads(state["params"], b0)
    comp, _ = compressed_grad_sync(local, grid.group("data"), init_errors(local))
    compressed_worst = _leaf_worst(_flat_tensors(comp), _flat_tensors(synced))
    del local, synced, comp
    _free()

    per_step = {"linrec_block_scan": 3 * layers}
    step_form = modeled_dp_step_traffic(data=2, block_elements=n_params, terms=3)
    torch.cuda.reset_peak_memory_stats(DEV)
    losses, step_ms, launched = [], [], {k: 0 for k in ops.KERNELS}
    for step in range(steps):
        b = src.batch_at(step)
        sync()
        ops.reset_launch_counts()
        comm.reset_comm_counts()
        t0 = time.perf_counter()
        state, metrics = tr.train_step(state, b)
        losses.append(float(metrics["loss"]))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts, coll = ops.launch_counts(), comm.comm_counts()
        expect_counts(counts, f"train_dp step {step} on rank {me}", **per_step)
        check(_nonzero(coll["calls"]) == step_form["counts_by_kind"]
              and _nonzero(coll["bytes"]) == step_form["bytes_by_kind"],
              f"train_dp step {step} on rank {me}: collectives {coll} != {step_form}")
        for k in ops.KERNELS:
            launched[k] += counts[k]
    peak_gb = torch.cuda.max_memory_allocated(DEV) / 1e9
    flat = torch.zeros(n_params + 3, dtype=torch.float32, device=DEV)
    allreduce_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        comm.all_reduce(flat, "sum", grid.group("data"))
        sync()
        allreduce_ms.append((time.perf_counter() - t0) * 1e3)
    del state, flat, tr
    _free()

    # fp32, one row a rank: the synced gradients and loss, then a step and a save
    c32 = dataclasses.replace(cfg, n_layers=fp32_layers, dtype="float32")
    ckpt_dir = os.path.join(workdir, "ckpt")
    tr32 = Trainer(c32, opt, mesh=grid, device=DEV, ckpt_dir=ckpt_dir)
    st32 = tr32.init_state(seed + 1)
    rows = {k: torch.as_tensor(v[:2]).to(DEV) for k, v in src.batch_at(0).items()}
    loss32, _, g32 = tr32.grads(st32["params"], rows)
    if me == 0:
        torch.save({k: v.cpu() for k, v in _flat_tensors(g32).items()},
                   os.path.join(workdir, "grads32.pt"))
    del g32
    st32, _ = tr32.train_step(st32, {k: v.cpu() for k, v in rows.items()})
    tr32.save(1, st32)
    places = _flat_tensors(tr32.state_shardings())
    whole = {k: sharding.gather(v, places[k]) for k, v in _flat_tensors(st32).items()}
    crcs = {k: _crc(v) for k, v in whole.items()} if me == 0 else None
    return {"rank": me, "coord": dict(grid.coord), "params": n_params, "losses": losses,
            "step_ms": step_ms, "launches": launched, "per_step": per_step,
            "step_collectives": step_form, "peak_mem_gb": peak_gb,
            "allreduce_ms": allreduce_ms, "allreduce_bytes": 4 * (n_params + 3),
            "compressed_worst": compressed_worst, "loss32": float(loss32),
            "ckpt_dir": ckpt_dir, "crcs": crcs, "transport": comm.transport(None, DEV)}


def _ep_params(cfg, grid, seed, dtype):
    """``cfg``'s parameters from ``seed`` with this rank's experts only; the ranks
    build them one after the other, so one whole model is on the card at a time."""
    params = None
    for r in range(comm.axis_size()):
        if comm.axis_index() == r:
            params = moe_model.expert_blocks(build_model(cfg).init(seed, device=DEV,
                                                                   dtype=dtype),
                                             grid, cfg.moe.n_experts)
            _free()
        comm.barrier()
    return params


def mesh_serve_rank(batch, prompt, new, seed, fp32_layers):
    """One rank of ``serve_ep``: deepseek-moe-16b on a (1 data, 2 model) grid, each
    rank holding 32 of each layer's 64 experts, greedy and ``topp_sharded``."""
    warnings.simplefilter("error", AutotuneFallbackWarning)
    grid = Grid((1, 2), ("data", "model"))
    me = comm.axis_index()
    cfg = get_config("deepseek-moe-16b")
    params = _ep_params(cfg, grid, seed, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(DEV)               # the serving peak, not the init's
    n_held = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)      # the same on every rank
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=DEV)
    uniforms = torch.rand((new, batch), generator=gen, device=DEV)
    inputs = {"tokens": prompts}
    eng = ServeEngine(cfg, params, mesh=grid, max_len=prompt + new, sampler="greedy",
                      scan_method="kernel")
    with torch.inference_mode(), sharding.use_mesh(grid):
        logits = eng.model.prefill(eng.params, inputs, cache_len=prompt + new)[0].float()
    layers = cfg.n_layers - cfg.moe.first_k_dense
    kw = dict(model=2, data=1, d_model=cfg.d_model, top_k=cfg.moe.top_k,
              n_experts=cfg.moe.n_experts, layers=layers, itemsize=2)
    ep_form = sum_forms(modeled_ep_traffic(tokens=batch * prompt, **kw),
                        modeled_ep_traffic(tokens=batch, passes=new - 1, **kw))
    out = {"rank": me, "coord": dict(grid.coord), "params_held": n_held,
           "logits": logits.cpu(), "ep_form": ep_form}
    per_pass = {"scan_mm": layers}
    for sampler in ("greedy", "topp_sharded"):
        eng.sampler = sampler
        u = uniforms if sampler == "topp_sharded" else None
        eng.generate(inputs, 2, uniforms=None if u is None else u[:2])     # warm-up
        sync()
        ops.reset_launch_counts()
        comm.reset_comm_counts()
        toks, t_full = _timed_generate(eng, inputs, new, uniforms=u)
        launches, coll = ops.launch_counts(), comm.comm_counts()
        expect_counts(launches, f"serve_ep {sampler} on rank {me}",
                      scan_mm=per_pass["scan_mm"] * new)
        form = ep_form
        if sampler == "topp_sharded":
            form = sum_forms(ep_form, *[modeled_dist_traffic(
                "dist_top_p_sample", d=2, n=cfg.padded_vocab, batch=batch)] * new)
        check(_nonzero(coll["calls"]) == form["counts_by_kind"]
              and _nonzero(coll["bytes"]) == form["bytes_by_kind"],
              f"serve_ep {sampler} on rank {me}: collectives {coll} != {form}")
        _, t_one = _timed_generate(eng, inputs, 1, uniforms=None if u is None else u[:1])
        out[sampler] = {"tokens": toks.cpu(), "launches": launches, "collectives": coll,
                        "generate_s": t_full, "prefill_plus_first_sample_ms": t_one * 1e3,
                        "decode_step_ms": (t_full - t_one) / (new - 1) * 1e3}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(DEV) / 1e9
    out["per_pass"] = per_pass
    out["transport"] = comm.transport(None, DEV)
    del eng, params
    _free()
    # the logits check: full width, fp32, the first fp32_layers layers
    c32 = dataclasses.replace(cfg, n_layers=fp32_layers, dtype="float32",
                              scan_method="kernel")
    p32 = _ep_params(c32, grid, seed, torch.float32)
    m32 = build_model(c32)
    with torch.inference_mode(), sharding.use_mesh(grid):
        out["logits32"] = m32.prefill(p32, inputs, cache_len=prompt + new)[0].cpu()
        with planted(comm, "psum", lambda x, group=None: x):    # the other part dropped
            out["fault32"] = m32.prefill(p32, inputs, cache_len=prompt + new)[0].cpu()
    return out


def phase_mesh():
    """``mesh``: ``train_dp`` (zamba2-1.2b, 2 data ranks) and ``serve_ep``
    (deepseek-moe-16b, 2 model ranks), each a world of 2 on the card.  Returns
    the kernels' launches summed over the ranks of both."""
    _free_card()
    t_phase = time.perf_counter()
    cfg = MESH_TRAIN
    wdir = _world_dir("mesh_train")
    t0 = time.perf_counter()
    ranks = run_world("chip_smoke:mesh_train_rank", 2, dict(cfg, workdir=wdir),
                      workdir=wdir, timeout=MESH_TIMEOUT, pythonpath=[ROOT])
    train_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        check(all(math.isfinite(x) for x in r["losses"]) and r["losses"][-1] < r["losses"][0],
              f"train_dp rank {r['rank']}: losses {r['losses']} not finite or not falling")
        check(r["losses"] == r0["losses"], "train_dp: the ranks report other losses")
        check(r["compressed_worst"][0] < COMPRESSED_TOL,
              f"train_dp: compressed_grad_sync {r['compressed_worst']} >= {COMPRESSED_TOL}")
    # the fp32 check against one rank on the same two rows, in this process
    zcfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=cfg["fp32_layers"],
                               dtype="float32")
    opt = AdamWConfig(lr=cfg["lr"], warmup_steps=20, total_steps=cfg["steps"])
    one = Trainer(zcfg, opt, device=DEV)
    st = one.init_state(cfg["seed"] + 1)
    src = SyntheticLM(zcfg.vocab_size, cfg["seq"], cfg["batch"])
    rows = {k: torch.as_tensor(v[:2]).to(DEV) for k, v in src.batch_at(0).items()}
    loss1, _, g1 = one.grads(st["params"], rows)
    ref = _flat_tensors(g1)
    world = torch.load(os.path.join(wdir, "grads32.pt"))
    grad_worst = _leaf_worst(world, ref)
    fault_worst = _leaf_worst({k: 2 * v for k, v in world.items()}, ref)
    loss_rel = abs(r0["loss32"] - float(loss1)) / abs(float(loss1))
    check(grad_worst[0] <= MESH_GRAD_TOL and loss_rel <= MESH_LOSS_RTOL,
          f"train_dp fp32: gradients {grad_worst}, loss {loss_rel} against one rank")
    check(fault_worst[0] > MESH_GRAD_TOL, f"train_dp fp32: the summed gradient reads "
          f"{fault_worst} <= {MESH_GRAD_TOL}")
    del g1, ref, world
    restored = CheckpointManager(r0["ckpt_dir"]).restore(1, st)
    same = {k: _crc(v) == r0["crcs"][k] for k, v in _flat_tensors(restored).items()}
    check(all(same.values()) and len(same) == len(r0["crcs"]),
          f"train_dp: the world's checkpoint restored on one rank differs: "
          f"{[k for k, v in same.items() if not v][:5]}")
    del st, restored, one
    _free_card()
    tokens = cfg["batch"] * cfg["seq"]
    train = {"arch": "zamba2-1.2b", "grid": [2, 1], "n_layers": cfg["layers"],
             "depth_cut": "38 -> %d (a multiple of shared_attn_interval 6)" % cfg["layers"],
             "params": r0["params"], "batch": cfg["batch"], "seq": cfg["seq"],
             "launches_per_step_rank": r0["per_step"], "losses": r0["losses"],
             "step_ms": [r["step_ms"] for r in ranks],
             "step_ms_median": [statistics.median(r["step_ms"]) for r in ranks],
             "tokens_per_s": tokens / (max(statistics.median(r["step_ms"]) for r in ranks)
                                       / 1e3),
             "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
             "allreduce_ms": [r["allreduce_ms"] for r in ranks],
             "allreduce_bytes": r0["allreduce_bytes"],
             "collectives_per_step": r0["step_collectives"]["counts_by_kind"],
             "collective_bytes_per_step": r0["step_collectives"]["bytes_by_kind"],
             "compressed_worst": [r["compressed_worst"] for r in ranks],
             "fp32_layers": cfg["fp32_layers"], "fp32_grad_worst": grad_worst,
             "fp32_grad_tol": MESH_GRAD_TOL, "fp32_fault_summed": fault_worst,
             "fp32_loss_rel": loss_rel, "checkpoint_leaves_bit_equal": len(same),
             "transport": r0["transport"], "seconds": train_s}

    scfg = MESH_SERVE
    t0 = time.perf_counter()
    sranks = run_world("chip_smoke:mesh_serve_rank", 2, scfg,
                       workdir=_world_dir("mesh_serve"), timeout=MESH_TIMEOUT,
                       pythonpath=[ROOT])
    serve_s = time.perf_counter() - t0
    s0 = sranks[0]
    for sampler in ("greedy", "topp_sharded"):
        toks = s0[sampler]["tokens"]
        check(tuple(toks.shape) == (scfg["batch"], scfg["new"]),
              f"serve_ep {sampler}: tokens of {tuple(toks.shape)}")
        for r in sranks[1:]:
            check(torch.equal(r[sampler]["tokens"], toks),
                  f"serve_ep {sampler}: rank {r['rank']}'s stream differs from rank 0's")
    dcfg = get_config("deepseek-moe-16b")
    params = build_model(dcfg).init(scfg["seed"], device=DEV, dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(scfg["seed"] + 1)
    prompts = torch.randint(0, dcfg.vocab_size, (scfg["batch"], scfg["prompt"]),
                            generator=gen, device=DEV)
    cache_len = scfg["prompt"] + scfg["new"]
    solo = ServeEngine(dcfg, params, max_len=cache_len, sampler="greedy", scan_method="kernel")
    with torch.inference_mode():
        ref = solo.model.prefill(params, {"tokens": prompts}, cache_len=cache_len)[0].float()
    solo_toks = solo.generate({"tokens": prompts}, scfg["new"]).cpu()
    bf16_err = [float((r["logits"] - ref.cpu()).abs().max() / ref.abs().max()) for r in sranks]
    del params, solo
    _free_card()
    c32 = dataclasses.replace(dcfg, n_layers=scfg["fp32_layers"], dtype="float32",
                              scan_method="kernel")
    p32 = build_model(c32).init(scfg["seed"], device=DEV, dtype=torch.float32)
    with torch.inference_mode():
        ref32 = build_model(c32).prefill(p32, {"tokens": prompts},
                                         cache_len=cache_len)[0].cpu()
    scale = float(ref32.abs().max())
    logit_err = [float((r["logits32"] - ref32).abs().max()) / scale for r in sranks]
    fault_err = float((s0["fault32"] - ref32).abs().max()) / scale
    check(max(logit_err) <= EP_LOGIT_TOL, f"serve_ep: fp32 prefill logits {logit_err} of "
          f"max|logit| from one rank's, above {EP_LOGIT_TOL}")
    check(fault_err > EP_LOGIT_TOL, f"serve_ep: dropping the other rank's part reads "
          f"{fault_err} <= {EP_LOGIT_TOL}")
    del p32
    _free_card()
    serve = {"arch": "deepseek-moe-16b", "grid": [1, 2], "dtype": "bfloat16",
             "experts_a_rank": dcfg.moe.n_experts // 2, "params_held": s0["params_held"],
             "batch": scfg["batch"], "prompt": scfg["prompt"], "new_tokens": scfg["new"],
             "scan_method": "kernel", "b1_per_pass_rank": s0["per_pass"]["scan_mm"],
             "fp32_layers": scfg["fp32_layers"], "fp32_logit_err": logit_err,
             "logit_tol": EP_LOGIT_TOL, "fp32_fault_dropped_part": fault_err,
             "bf16_full_depth_logit_err": bf16_err,
             "greedy_agreement_with_one_rank":
                 float((s0["greedy"]["tokens"] == solo_toks).float().mean()),
             "ep_collectives": s0["ep_form"]["counts_by_kind"],
             "ep_collective_bytes": s0["ep_form"]["bytes_by_kind"],
             **{f"{k}_{m}": [r[k][m] for r in sranks]
                for k in ("greedy", "topp_sharded")
                for m in ("prefill_plus_first_sample_ms", "decode_step_ms")},
             "peak_mem_gb": [r["peak_mem_gb"] for r in sranks],
             "transport": s0["transport"], "seconds": serve_s}
    emit({"phase": "mesh", "train_dp": train, "serve_ep": serve,
          "seconds": time.perf_counter() - t_phase})
    counts = collections.Counter()
    for r in ranks:
        counts.update(r["launches"])
    for r in sranks:
        for sampler in ("greedy", "topp_sharded"):
            counts.update(r[sampler]["launches"])
    return {k: counts[k] for k in ops.KERNELS}


# ---------------------------------------------------------------------------
# the dry run's prediction against an allocation on the card, and the examples
# ---------------------------------------------------------------------------

# the dry run's cell allocated for real: zamba2-1.2b x long_500k on a 1 x 1 grid
DRYRUN = dict(arch="zamba2-1.2b", shape="long_500k", mesh_shape=(1, 1), seed=0)
DRYRUN_TOL = 0.01                   # allocated growth against the predicted arguments
# each example's arguments on the card (small, as the CPU tests run them)
EXAMPLES = {"quickstart": [], "scan_operators": [],
            "serve_topp": ["--batch", "2", "--prompt-len", "16", "--new-tokens", "6"],
            "serve_continuous": [],
            "train_lm": ["--steps", "20", "--seq", "64"]}


def phase_dryrun():
    """``launch/dryrun.py``'s record of zamba2-1.2b x long_500k on a 1 x 1 grid, then
    that cell allocated on the card: fp32 ``init`` and the hybrid ``empty_caches(1,
    524288)`` in bf16, the token and ``pos``.  The growth of
    ``torch.cuda.memory_allocated()`` must lie within ``DRYRUN_TOL`` of the predicted
    ``bytes_per_device.arguments``; one ``decode_step`` at position 524287 gives
    finite logits; its ms and the peak GB are printed beside the prediction."""
    rec = dryrun.run_cell(DRYRUN["arch"], DRYRUN["shape"], "single",
                          mesh_shape=DRYRUN["mesh_shape"])
    pred = rec["bytes_per_device"]["arguments"]
    shape = SHAPES[DRYRUN["shape"]]
    cfg = dataclasses.replace(get_config(DRYRUN["arch"]), scan_method="matmul",
                              scan_layers=False)
    model = build_model(cfg)
    meta = model.empty_caches(shape.global_batch, shape.seq_len, device="meta")
    pred_caches = sum(t.numel() * t.element_size() for t in _leaves(meta))
    _free()
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    t0 = time.perf_counter()
    params = model.init(DRYRUN["seed"], device=DEV)
    caches = model.empty_caches(shape.global_batch, shape.seq_len, device=DEV)
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=DEV)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=DEV)
    sync()
    alloc_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated(DEV) - base
    rel = abs(grown - pred) / pred
    check(rel <= DRYRUN_TOL, f"dryrun: the cell allocated {grown} bytes on the card, the "
          f"dry run predicted {pred} ({rel:.4%} apart > {DRYRUN_TOL:.0%})")
    step = lambda: model.decode_step(params, tokens, caches, int(pos))   # noqa: E731
    logits, _ = step()                                                   # warm-up
    sync()
    t0 = time.perf_counter()
    logits, _ = step()
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (shape.global_batch, cfg.padded_vocab)
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          f"dryrun: decode at position {shape.seq_len - 1} gave logits of shape "
          f"{tuple(logits.shape)} or non-finite values")
    peak = torch.cuda.max_memory_allocated(DEV) - base
    out = {"phase": "dryrun", "cell": f"{DRYRUN['arch']} x {DRYRUN['shape']} x "
           f"{DRYRUN['mesh_shape'][0]}x{DRYRUN['mesh_shape'][1]}",
           "predicted_arguments_bytes": pred, "predicted_cache_bytes": pred_caches,
           "predicted_param_bytes": rec["n_params"] * 4, "allocated_bytes": grown,
           "allocated_vs_predicted": grown / pred, "alloc_s": alloc_s,
           "decode_ms": decode_ms, "peak_gb": peak / 1e9, "predicted_gb": pred / 1e9,
           "n_params": rec["n_params"], "plan_s": rec["lower_s"]}
    emit(out)
    print(f"dryrun: {out['cell']}: predicted {pred / 1e9:.3f} GB "
          f"({rec['n_params'] * 4 / 1e9:.3f} GB fp32 params + {pred_caches / 1e9:.3f} GB "
          f"caches), allocated "
          f"{grown / 1e9:.3f} GB; decode at {shape.seq_len - 1}: {decode_ms:.2f} ms, peak "
          f"{peak / 1e9:.3f} GB", flush=True)
    del params, caches, logits
    _free()
    return out


def _load_example(name: str):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples():
    """Each ``examples/torch_*.py`` ``main()`` in-process on the card (no
    ``--device``: the card is the default) at the arguments of ``EXAMPLES``, the
    counters zeroed just before and read just after each; every check it prints
    holds.  Returns the launches summed, which the kernels line counts."""
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    runs, total = {}, {k: 0 for k in ops.KERNELS}
    for name, argv in EXAMPLES.items():
        argv = argv + (["--ckpt-dir", ckpt] if name == "train_lm" else [])
        mod = _load_example(name)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(argv)
        sync()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(res["checks"] and all(res["checks"].values()),
              f"examples: torch_{name}.py: a check failed: {res['checks']}")
        runs[name] = {"seconds": secs, "checks": res["checks"],
                      "launches": {k: v for k, v in counts.items() if v}}
        if name == "serve_continuous":
            runs[name]["host_syncs"] = res["host_syncs"]
            runs[name]["ticks"] = res["stats"]["ticks"]
        for k in ops.KERNELS:
            total[k] += counts[k]
        _free()
    emit({"phase": "examples", "runs": runs})
    return total


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def phase_timing(gen, dist_sort_ms):
    out = {}
    b, n = SCAN_SHAPE
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    k, pl = paired_ms(lambda: scan_mm.scan_tiles(x, s=128, variant="scanul1"),
                      lambda: scan_mm.scan_tiles_plain(x, s=128, variant="scanul1",
                                                       acc=torch.float32), 10)
    lib = cuda_ms(lambda: torch.cumsum(x, -1), 5)
    bms, by = bound(b * n * 8, b * n)
    x8 = x.to(torch.int8)
    k8 = cuda_ms(lambda: scan_mm.scan_tiles(x8, s=128), 10)
    k16 = cuda_ms(lambda: scan_mm.scan_tiles(x, s=16), 10)
    out["B1"] = dict(ms=k, plain_ms=pl, library_ms=lib, bound_ms=bms, bound_by=by,
                     int8_ms=k8, int8_bound_ms=bound(b * n * 5)[0], s16_ms=k16,
                     device_ms=graph_ms(lambda: scan_mm.scan_tiles(x, s=128), 10),
                     s16_device_ms=graph_ms(lambda: scan_mm.scan_tiles(x, s=16), 10))

    v = 128256
    keys16 = torch.softmax(torch.randn((VOCAB_ROWS, v), generator=gen, device=DEV) * 2,
                           -1).to(torch.bfloat16)
    work = _enc16_desc(keys16)
    perm = torch.arange(v, dtype=torch.int32, device=DEV).expand(VOCAB_ROWS, v).contiguous()

    def plain_chain():
        w, pm = work, perm
        for sh in range(0, 16, 4):
            w, pm = split_mm.radix_pass_plain(w, pm, shift=sh, pass_bits=4)
        return w, pm

    def chain(bpp):
        return lambda: ops.radix_sort_enc_kernel(work, bits=16, bits_per_pass=bpp)

    def one():
        split_mm.radix_pass_multibit(work, perm, shift=0, pass_bits=4)

    def lib():
        torch.sort(keys16, dim=-1, descending=True, stable=True)

    # ms: back-to-back eager calls, as every row is timed (host in the loop);
    # device_ms: the same calls replayed as a CUDA graph, the kernels' device time
    # alone (a pass is a few microseconds of device work under tens of Python,
    # allocation and launch)
    k, pl = paired_ms(chain(4), plain_chain, 50)
    # the chain's function: 2-byte keys in, 2-byte keys and 4-byte perm out
    out["B7"] = dict(ms=k, plain_ms=pl, library_ms=cuda_ms(lib, 50),
                     bound_ms=bound(VOCAB_ROWS * v * 8)[0], bound_by="bytes",
                     device_ms=graph_ms(chain(4), 200), library_device_ms=graph_ms(lib, 200),
                     ms_per_pass=cuda_ms(one, 50), device_ms_per_pass=graph_ms(one, 200),
                     pass_bound_ms=bound(VOCAB_ROWS * v * 12)[0],
                     bits8_ms=cuda_ms(chain(8), 50), bits8_device_ms=graph_ms(chain(8), 200))

    sp = torch.sort(torch.softmax(torch.randn((VOCAB_ROWS, v), generator=gen, device=DEV) * 4,
                                  -1), -1, descending=True).values
    u = torch.rand((VOCAB_ROWS, 1), generator=gen, device=DEV)
    k, pl = paired_ms(lambda: split_mm.topp_mask_sample_tiles(sp, u, p=0.9),
                      lambda: split_mm.topp_tail_plain(sp, u, p=0.9), 50)
    bms, by = bound(VOCAB_ROWS * (v * 4 + 8), VOCAB_ROWS * v * 5)
    out["B8"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
                     device_ms=graph_ms(lambda: split_mm.topp_mask_sample_tiles(sp, u, p=0.9),
                                        200),
                     design_device_ms=time_topp_design(sp, u, 0.9))
    n1m = 1 << 20
    sp1m = torch.sort(torch.softmax(torch.randn((VOCAB_ROWS, n1m), generator=gen, device=DEV)
                                    * 4, -1), -1, descending=True).values
    out["B8"]["n1m"] = dict(
        rounds=split_mm.topp_tail_geometry(n1m)[1],
        ms=cuda_ms(lambda: split_mm.topp_mask_sample_tiles(sp1m, u, p=0.9), 50),
        device_ms=graph_ms(lambda: split_mm.topp_mask_sample_tiles(sp1m, u, p=0.9), 100),
        plain_ms=cuda_ms(lambda: split_mm.topp_tail_plain(sp1m, u, p=0.9), 20),
        bound_ms=bound(VOCAB_ROWS * (n1m * 4 + 8), VOCAB_ROWS * n1m * 5)[0])
    del sp1m
    # the yardstick of a launch bound by latency: one zero_() of 4 elements
    z4 = torch.zeros(4, device=DEV)
    launch_floor = dict(ms=cuda_ms(z4.zero_, 200), device_ms=graph_ms(z4.zero_, 500))

    logits = torch.randn((VOCAB_ROWS, v), generator=gen, device=DEV) * 4
    uu = torch.rand((VOCAB_ROWS, 1), generator=gen, device=DEV)
    sampler = {m: cuda_ms(lambda m=m: top_p_sample(logits, method=m, u=uu), 20)
               for m in ("kernel", "blocked", "vector", "matmul")}
    sampler["xla_argsort"] = cuda_ms(
        lambda: top_p_sample(logits, method="vector", sort_method="xla", u=uu), 20)
    # the kernel sampler's device time alone: softmax, four B7 passes and B8
    sampler["kernel_device_ms"] = graph_ms(lambda: top_p_sample(logits, method="kernel",
                                                                u=uu), 50)
    out.update(time_pipeline(x, x8))
    out["B1"].update(pipeline_ms=out["pipeline"]["ms"],
                     faster_than_pipeline=out["B1"]["ms"] < out["pipeline"]["ms"])
    out.update(time_split(gen))
    out.update(time_seg(gen))
    out.update(time_linrec(gen))
    out.update(time_b6_b17(gen))
    out.update(time_b7h(gen))
    emit({"phase": "timing", "kernels": out, "top_p_sample_ms": sampler,
          "launch_floor": launch_floor,
          "dist_sort_f32_ms": {f"D{d}": ms for d, ms in dist_sort_ms.items()},
          "dist_sort_transport": "gloo over loopback, operands staged through host memory",
          "segment_top_p_sample_ms": out.pop("segment_top_p_sample_ms"),
          "shapes": {"B1": list(SCAN_SHAPE), "B2-B4": list(SCAN_SHAPE),
                     "B5": [[b, n], [VOCAB_ROWS, v]], "B7": [VOCAB_ROWS, v],
                     "B8": [[VOCAB_ROWS, v], [VOCAB_ROWS, 1 << 20]],
                     "B9-B12": list(SCAN_SHAPE),
                     "B11": [[b, out["B11"]["nb"]], list(B11_LARGE)],
                     "B13-B16": [list(SCAN_SHAPE), list(SSD_ROWS)],
                     "B6": [list(SCAN_SHAPE)] + [[VOCAB_ROWS, VOCAB // dd]
                                                  for dd in DIST_WORLDS], "B7h": [list(B7H_SHAPE), [B7H_SHAPE[0],
                                                                         2 * B7H_SHAPE[1]]],
                     "dist_sort": list(DIST_SHAPE), "B17": [SSD[k] for k in (
                         "batch", "seq", "heads", "head_dim", "state", "chunk")],
                     "segment_top_p_sample": [4 * VOCAB]}})
    return out


# B8's design options, (threads a CTA, CTAs a cluster), run by csrc/topp_tail.cu's
# repro_topp_tail_design; t256_c8 is the shipped kernel at (4, 128256), c1 one CTA a
# row in rounds.
B8_DESIGNS = {"t256_c8": (256, 8), "t512_c8": (512, 8), "t1024_c8": (1024, 8),
              "t256_c4": (256, 4), "t1024_c1": (1024, 1)}


def time_topp_design(sp, u, p) -> dict:
    """B8's design options on ``sp``, each checked against its model and timed as a
    CUDA-graph replay (device ms)."""
    b, n = sp.shape
    out_j = torch.empty(b, dtype=torch.int32, device=DEV)
    res = {}
    for name, (threads, cluster) in B8_DESIGNS.items():
        def run(threads=threads, cluster=cluster):
            _build.launch("topp_tail", sp.data_ptr(), sp.stride(0), u.data_ptr(),
                          out_j.data_ptr(), b, n, p, threads, cluster,
                          torch.cuda.current_stream(DEV).cuda_stream,
                          entry="repro_topp_tail_design")
        run()
        sync()
        want = split_mm._topp_tail_cluster(sp.cpu(), u.cpu(), p=p, cluster=cluster,
                                           threads=threads)
        check(torch.equal(out_j.cpu(), want), f"B8 design {name}: != its model")
        res[name] = graph_ms(run, 200)
    return res


def time_pipeline(x, x8):
    """B2, B3, B4, B2 + B3 in one launch (``B2B3``) and the whole pipeline at the
    default geometry (s=128, 8 tiles: 128 blocks per row), fp32, int8 and bf16, each
    kernel timed eagerly in turns with its plain version (``ms``) and as a CUDA-graph
    replay (``device_ms``); the fused launch beside B2 followed by B3, also at s=16 with
    one tile a block (65536 blocks a row).  The keys without a prefix are fp32's."""
    b, n = x.shape
    m, block_len, nb = scan_pipeline.block_geometry(n, 128, 8)
    out = {"B2": {}, "B3": {}, "B4": {}, "B2B3": {}, "pipeline": {}}

    def two_launches(blocks):
        return lambda: scan_pipeline.carry_scan(scan_pipeline.block_partial_sums(blocks))

    for name, xx in (("", x), ("int8_", x8), ("bf16_", x.to(torch.bfloat16))):
        blocks = xx.reshape(b, nb, m, 128)
        acc = accum_dtype_for(xx.dtype)
        esz, fl = xx.element_size(), xx.is_floating_point()
        sums = scan_pipeline.block_partial_sums_plain(blocks, acc)
        carries = scan_pipeline.carry_scan_plain(sums)
        k, pl = paired_ms(lambda: scan_pipeline.block_partial_sums(blocks),
                          lambda: scan_pipeline.block_partial_sums_plain(blocks, acc), 10)
        bms, by = bound(b * n * esz + b * nb * 4, b * n if fl else 0)
        out["B2"].update({name + "ms": k, name + "plain_ms": pl, name + "bound_ms": bms,
                          name + "bound_by": by, name + "library_ms": cuda_ms(
                              lambda: torch.sum(blocks, dim=(-2, -1), dtype=acc), 10),
                          name + "device_ms": graph_ms(
                              lambda: scan_pipeline.block_partial_sums(blocks), 20)})
        k, pl = paired_ms(lambda: scan_pipeline.block_sums_carries(blocks),
                          lambda: scan_pipeline.block_sums_carries_plain(blocks, acc), 10)
        bms, by = bound(b * n * esz + 2 * b * nb * 4, b * (n + nb) if fl else 0)
        out["B2B3"].update({name + "ms": k, name + "plain_ms": pl, name + "bound_ms": bms,
                            name + "bound_by": by, name + "library_ms": None,
                            name + "device_ms": graph_ms(
                                lambda: scan_pipeline.block_sums_carries(blocks), 20),
                            name + "b2_then_b3_ms": cuda_ms(two_launches(blocks), 10),
                            name + "b2_then_b3_device_ms": graph_ms(two_launches(blocks), 20)})
        k, pl = paired_ms(lambda: scan_pipeline.carry_scan(sums),
                          lambda: scan_pipeline.carry_scan_plain(sums), 50)
        bms, by = bound(b * nb * 8, b * nb if fl else 0)
        out["B3"].update({name + "ms": k, name + "plain_ms": pl, name + "bound_ms": bms,
                          name + "bound_by": by, name + "library_ms": None,
                          name + "device_ms": graph_ms(
                              lambda: scan_pipeline.carry_scan(sums), 200)})
        k, pl = paired_ms(
            lambda: scan_pipeline.block_scan_carry(blocks, carries),
            lambda: scan_pipeline.block_scan_carry_plain(blocks, carries, variant="scanul1",
                                                         acc=acc), 10)
        bms, by = bound(b * n * (esz + 4) + b * nb * 4, 3 * b * n if fl else 0)
        out["B4"].update({name + "ms": k, name + "plain_ms": pl, name + "bound_ms": bms,
                          name + "bound_by": by, name + "library_ms": None,
                          name + "scanu_ms": cuda_ms(lambda: scan_pipeline.block_scan_carry(
                              blocks, carries, variant="scanu"), 10),
                          name + "device_ms": graph_ms(
                              lambda: scan_pipeline.block_scan_carry(blocks, carries), 20)})
        k, pl = paired_ms(
            lambda: scan(xx, method="blocked"),
            lambda: scan_pipeline.blocked_scan_plain(xx, s=128, block_tiles=8,
                                                     variant="scanul1", acc=acc), 10)
        out["pipeline"].update({
            name + "ms": k, name + "plain_ms": pl,
            name + "device_ms": graph_ms(lambda: scan(xx, method="blocked"), 10),
            name + "library_ms": cuda_ms(lambda: torch.cumsum(xx, -1, dtype=acc), 5),
            name + "bound_ms": bound(b * n * (esz + 4))[0],               # the scan's bytes
            name + "pipeline_bytes_bound_ms": bound(b * n * (2 * esz + 4))[0]})
    # s=16, one tile per block: 65536 blocks a row, where B3 has real work
    m16, _, nb16 = scan_pipeline.block_geometry(n, 16, 1)
    for name, xx in (("", x), ("int8_", x8)):
        blocks = xx.reshape(b, nb16, m16, 16)
        def fused(blocks=blocks):
            return scan_pipeline.block_sums_carries(blocks)
        out["B2B3"].update({
            name + "nb65536_ms": cuda_ms(fused, 10),
            name + "nb65536_device_ms": graph_ms(fused, 20),
            name + "nb65536_b2_then_b3_ms": cuda_ms(two_launches(blocks), 10),
            name + "nb65536_b2_then_b3_device_ms": graph_ms(two_launches(blocks), 20),
            name + "nb65536_bound_ms": bound(b * n * xx.element_size() + 2 * b * nb16 * 4)[0]})
    big = torch.randn((b, nb16), device=DEV)
    out["B3"]["nb65536_ms"], out["B3"]["nb65536_plain_ms"] = paired_ms(
        lambda: scan_pipeline.carry_scan(big), lambda: scan_pipeline.carry_scan_plain(big), 20)
    out["B3"]["nb65536_bound_ms"] = bound(b * nb16 * 8, b * nb16)[0]
    return out


def time_split(gen):
    """B5 at (4, 2^24) and (4, 128256), fp32 payload and bool flags, in turns with
    its plain version, and as a CUDA-graph replay (``device_ms``); beside it a stable
    argsort of the flags plus a gather of the payload (two PyTorch calls: no single
    call is the same function)."""
    res = {}
    for n5, reps, key in ((SCAN_SHAPE[1], 3, "B5"), (VOCAB, 20, "B5_vocab")):
        shape = (SCAN_SHAPE[0], n5)
        f = torch.rand(shape, generator=gen, device=DEV) < 0.5
        xx = torch.randn(shape, generator=gen, device=DEV)
        order_key = (~f).to(torch.uint8)
        k, pl = paired_ms(lambda: split_mm.split_tiles(xx, f),
                          lambda: split_mm.split_plain(xx, f), reps)
        two = cuda_ms(lambda: torch.gather(
            xx, -1, torch.argsort(order_key, dim=-1, stable=True)), reps)
        res[key] = dict(ms=k, plain_ms=pl, library_ms=None, argsort_gather_ms=two,
                        device_ms=graph_ms(lambda: split_mm.split_tiles(xx, f), 10 * reps),
                        bound_ms=bound(shape[0] * n5 * 13 + shape[0] * 4)[0],
                        bound_by="bytes")
    return res


def trailing_elements(fblocks) -> int:
    """Elements of the blocks' trailing segments: from each block's last flag to its
    end, the whole block where it has none.  B10's outputs depend on these alone."""
    fb = fblocks.flatten(-2) != 0
    rank = torch.arange(fb.shape[-1], device=fb.device)
    return int((fb.shape[-1] - torch.where(fb, rank, 0).amax(-1)).sum())


# B10's design options, (threads a CTA at most, walk from the block's end, skip the
# values before a run's last flag), run by csrc/seg_summaries.cu's
# repro_seg_summaries_design; walk_t256 is the shipped kernel.
B10_DESIGNS = {"walk_t256": (256, 1, 1), "walk_t128": (128, 1, 1), "walk_t512": (512, 1, 1),
               "sweep_t256": (256, 0, 1), "sweep_t512": (512, 0, 1),
               "walk_t256_noskip": (256, 1, 0)}


def time_seg_summaries_design(x, flags, block_len: int, nb: int) -> dict:
    """B10's design options on fp32 rows ``x`` cut into blocks of ``block_len``, with
    three layouts of flags a row (``flags``, none, every element), each timed as a
    CUDA-graph replay (device ms) beside that layout's bound.  Each option's
    has-boundary equals the plain version's and its sums lie within ``B1_F32_ULP`` of
    the fp64 trailing sums; the shipped option's are the wrapper's bits."""
    b, n = x.shape
    ts = torch.empty((b, nb), dtype=torch.float32, device=DEV)
    hb = torch.empty((b, nb), dtype=torch.int32, device=DEV)
    blocks = x.reshape(b, nb, 1, block_len)
    out = {}
    for lname, lay in (("segments", flags != 0),
                       ("none", torch.zeros((b, n), dtype=torch.bool, device=DEV)),
                       ("all", torch.ones((b, n), dtype=torch.bool, device=DEV))):
        fk, fstride = segscan_mm._flag_rows(lay, x.shape)
        fblocks = lay.reshape(b, nb, 1, block_len)
        _, ref_h = segscan_mm.seg_block_summaries_plain(blocks, fblocks, torch.float32)
        r64, _ = segscan_mm.seg_block_summaries_plain(blocks.double(), fblocks, torch.float64)
        a64, _ = segscan_mm.seg_block_summaries_plain(blocks.double().abs(), fblocks,
                                                       torch.float64)
        shipped, _ = segscan_mm.seg_block_summaries(blocks, fblocks)
        trailing = trailing_elements(fblocks)
        row = {"bound_ms": bound(trailing * 5 + b * nb * 8)[0], "trailing_elements": trailing}
        for name, (threads, from_end, skip) in B10_DESIGNS.items():
            def run(threads=threads, from_end=from_end, skip=skip):
                _build.launch("seg_summaries", x.data_ptr(), fk.data_ptr(), fstride,
                              ts.data_ptr(), hb.data_ptr(), b, n, nb, block_len, threads,
                              from_end, skip, torch.cuda.current_stream(DEV).cuda_stream,
                              entry="repro_seg_summaries_design")
            run()
            sync()
            tag = f"B10 design {name} flags {lname}"
            check(torch.equal(hb, ref_h.to(torch.int32)), f"{tag}: has-boundary != plain")
            ulp = max_ulp_dev(ts, r64, a64)
            check(ulp <= B1_F32_ULP, f"{tag}: {ulp} ulp > {B1_F32_ULP}")
            if name == "walk_t256":
                check(torch.equal(ts, shipped), f"{tag}: not the wrapper's bits")
            row[name] = graph_ms(run, 50)
        out[lname] = row
    return out


def time_seg(gen):
    """B9-B12 and the segmented pipeline at (4, 2^24) fp32, each row cut into its own
    segments, timed in turns with their plain versions; beside them the operator on
    offsets shared by the rows (``segment_scan`` with ``"vector"``, the unsegmented
    cumsum minus a gather, and with the two kernel methods), and the packed sampler
    at (4 * 128256,) for each method.  B10 is also timed as a CUDA-graph replay
    (``device_ms``); its bound counts the flags and values of the blocks' trailing
    segments, and beside it stand the bytes of every flag byte with those values
    (``every_flag_bound_ms``) and of every flag and value (``all_values_bound_ms``),
    and its design options (``design_device_ms``).  No single PyTorch call computes a
    segmented scan, so ``library_ms`` is None."""
    rng = np.random.default_rng(SEG_SEED + 2)
    b, n = SCAN_SHAPE
    flags = torch.stack([boundary_flags(seg_offsets(rng, n), n) for _ in range(b)])
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    f32 = torch.float32
    out = {}
    k, pl = paired_ms(lambda: segscan_mm.seg_scan_tiles(x, flags),
                      lambda: segscan_mm.seg_scan_tiles_plain(x, flags != 0, s=128, acc=f32),
                      10)
    bms, by = bound(b * n * 9, b * n)                  # 4 B in, 1 B of flags, 4 B out
    x1, f1 = sampler_scan_inputs(gen)
    n1 = x1.shape[-1]
    out["B9"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
                     device_ms=graph_ms(lambda: segscan_mm.seg_scan_tiles(x, flags), 10),
                     sampler_ms=cuda_ms(lambda: segscan_mm.seg_scan_tiles(x1, f1), 50),
                     sampler_device_ms=graph_ms(lambda: segscan_mm.seg_scan_tiles(x1, f1), 200),
                     sampler_bound_ms=bound(n1 * 6)[0])     # 1 B in, 1 B of flags, 4 B out
    m, block_len, nb = scan_pipeline.block_geometry(n, 128, 8)
    blocks, fblocks = x.reshape(b, nb, m, 128), flags.reshape(b, nb, m, 128)
    k, pl = paired_ms(lambda: segscan_mm.seg_block_summaries(blocks, fblocks),
                      lambda: segscan_mm.seg_block_summaries_plain(blocks, fblocks, f32), 10)
    trailing = trailing_elements(fblocks)
    bms, by = bound(trailing * 5 + b * nb * 8, trailing)
    out["B10"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
                      trailing_elements=trailing, device_ms=graph_ms(
                          lambda: segscan_mm.seg_block_summaries(blocks, fblocks), 50),
                      every_flag_bound_ms=bound(b * n + trailing * 4 + b * nb * 8)[0],
                      all_values_bound_ms=bound(b * n * 5 + b * nb * 8)[0],
                      design_device_ms=time_seg_summaries_design(x, flags, block_len, nb))
    ts, hb = segscan_mm.seg_block_summaries_plain(blocks, fblocks, f32)
    out["B11"] = time_seg_carry(ts, hb, gen)
    carries = segscan_mm.seg_carry_scan_plain(ts, hb)
    k, pl = paired_ms(lambda: segscan_mm.seg_block_scan_carry(blocks, fblocks, carries),
                      lambda: segscan_mm.seg_block_scan_carry_plain(blocks, fblocks, carries,
                                                                    f32), 3)
    bms, by = bound(b * n * 9 + b * nb * 4, b * n)
    out["B12"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
                      device_ms=graph_ms(lambda: segscan_mm.seg_block_scan_carry(
                          blocks, fblocks, carries), 10))
    k, pl = paired_ms(lambda: segscan_mm.seg_blocked_scan(x, flags),
                      lambda: segscan_mm.seg_blocked_scan_plain(x, flags != 0, s=128,
                                                                block_tiles=8, acc=f32), 10)
    off = seg_offsets(rng, n)
    out["B9"].update(pipeline_ms=k, faster_than_pipeline=out["B9"]["ms"] < k)
    out["seg_pipeline"] = dict(
        ms=k, plain_ms=pl, library_ms=None, bound_ms=bound(b * n * 9)[0],
        segment_scan_shared_offsets_ms={m_: cuda_ms(lambda m_=m_: segment_scan(
            x, off, method=m_), 5) for m_ in ("vector", "kernel", "blocked")})
    logits = torch.randn((4 * VOCAB,), generator=gen, device=DEV) * 4
    poff = torch.arange(5, dtype=torch.int32, device=DEV) * VOCAB
    uu = torch.rand((4, 1), generator=gen, device=DEV)
    out["segment_top_p_sample_ms"] = {
        m_: cuda_ms(lambda m_=m_: segment_top_p_sample(logits, poff, method=m_, u=uu), 10)
        for m_ in ("kernel", "blocked", "vector", "matmul")}
    return out


def time_seg_carry(ts, hb, gen) -> dict:
    """B11 on the pipeline's summaries ``(ts, hb)`` (one tile a row) in turns with
    its plain version, eagerly and as a CUDA-graph replay, and at ``B11_LARGE``
    (many tiles a row, the look-back) on random summaries with a
    flag a thousand blocks, beside the plain version's tile model
    (``seg_carry_scan_plain(tile=)``; the untiled masked contraction would hold
    2^40 elements).  Bound: 12 B a summary (4 B of sums and of flag words in, 4 B
    out), and one add a summary."""
    b, nb = ts.shape
    k, pl = paired_ms(lambda: segscan_mm.seg_carry_scan(ts, hb),
                      lambda: segscan_mm.seg_carry_scan_plain(ts, hb), 50)
    bms, by = bound(b * nb * 12, b * nb)
    res = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by, nb=nb,
               device_ms=graph_ms(lambda: segscan_mm.seg_carry_scan(ts, hb), 500))
    b1, nb1 = B11_LARGE
    t1 = torch.randn((b1, nb1), generator=gen, device=DEV)
    h1 = (torch.rand((b1, nb1), generator=gen, device=DEV) < 1e-3).to(torch.int32)
    tile = segscan_mm.seg_scan_tile(nb1)
    k1, pl1 = paired_ms(lambda: segscan_mm.seg_carry_scan(t1, h1),
                        lambda: segscan_mm.seg_carry_scan_plain(t1, h1, tile=tile, s=16), 5,
                        kernel_reps=50)
    res["nb1m"] = dict(shape=[b1, nb1], ms=k1, plain_tile_ms=pl1,
                       device_ms=graph_ms(lambda: segscan_mm.seg_carry_scan(t1, h1), 200),
                       bound_ms=bound(b1 * nb1 * 12, b1 * nb1)[0])
    return res


def time_linrec(gen):
    """B13-B16 and the pipeline on random fp32 rows at (4, 2^24) (s=128, 8 tiles a
    block: 128 blocks a row) and at the SSD shape (the rows of (4, 16, 64, 64, 64)
    along axis 1: 2^20 rows of 16, one block each), each in turns with its plain
    version.  No single PyTorch call computes the general recurrence, so
    ``library_ms`` is None; beside B13 stands ``torch.cumsum``, the a = 1 case.
    B14 + B15 in one launch (``B14B15``) eagerly and as a graph replay, beside B14
    followed by B15, at the default geometry and at s=16 with one tile a block
    (65536 blocks a row); and ``B15.fused_by_nb``: the two at 128, 256, 512, 1024
    and 65536 blocks a row of (4, 2^24), the times that set
    ``linrec_mm.LINREC_FUSED_NB_MAX``."""
    out = {}
    a, b = lin_inputs(gen, SCAN_SHAPE)["random"]
    rows, n = SCAN_SHAPE
    ab, bb, nb, block_len = block_views(a, b, 128, 8)
    f32 = torch.float32
    k, pl = paired_ms(lambda: linrec_mm.linrec_scan_tiles(a, b),
                      lambda: linrec_mm.linrec_scan_tiles_plain(a, b, s=128, acc=f32), 1,
                      kernel_reps=10)
    out["B13"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bound(rows * n * 12)[0],
                      bound_by="bytes", cumsum_a1_ms=cuda_ms(lambda: torch.cumsum(b, -1), 5),
                      device_ms=graph_ms(lambda: linrec_mm.linrec_scan_tiles(a, b), 10))
    # the dist phase's shards of dist_linear_scan: (4, 2^22) at D = 4, (4, 2^23) at D = 2
    for dd in DIST_WORLDS:
        w = n // dd
        sa, sb = a[:, :w].contiguous(), b[:, :w].contiguous()
        sab, sbb, snb, sbl = block_views(sa, sb, 128, 8)
        scin = torch.zeros((rows, snb), device=DEV)
        out["B13"][f"d{dd}_shard_ms"] = cuda_ms(lambda: linrec_mm.linrec_scan_tiles(sa, sb), 10)
        out["B13"][f"d{dd}_shard_bound_ms"] = bound(rows * w * 12)[0]
        out[f"B16_d{dd}_shard"] = dict(
            ms=cuda_ms(lambda: linrec_mm.linrec_block_scan_carry(sab, sbb, scin), 10),
            bound_ms=bound(rows * w * 12 + rows * snb * 4)[0], shape=[rows, w])
        del sa, sb, sab, sbb
    k, pl = paired_ms(lambda: linrec_mm.linrec_block_summaries(ab, bb),
                      lambda: linrec_mm.linrec_block_summaries_plain(ab, bb, f32), 5)
    out["B14"] = dict(ms=k, plain_ms=pl, library_ms=None,
                      bound_ms=bound(rows * n * 8 + rows * nb * 8)[0], bound_by="bytes",
                      device_ms=graph_ms(lambda: linrec_mm.linrec_block_summaries(ab, bb), 10))
    pp, pl_ = linrec_mm.linrec_block_summaries_plain(ab, bb, f32)
    k, pl = paired_ms(lambda: linrec_mm.linrec_carry_scan(pp, pl_),
                      lambda: linrec_mm.linrec_carry_scan_plain(pp, pl_), 20)
    bms, by = bound(rows * nb * 12, rows * nb * 2)
    out["B15"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by, nb=nb,
                      device_ms=graph_ms(lambda: linrec_mm.linrec_carry_scan(pp, pl_), 200))

    def two_launches(ab_, bb_):
        return lambda: linrec_mm.linrec_carry_scan(*linrec_mm.linrec_block_summaries(ab_, bb_))

    def fused_launch(ab_, bb_):
        return lambda: linrec_mm.linrec_summaries_carries(ab_, bb_)

    # the fused launch against B14 then B15 by blocks a row, device times in turns
    # (two, fused, fused, two) and eager; the default geometry first, one tile a block
    # (B2B3's nb65536 shape) last
    by_nb = {}
    for s1, bt1 in ((128, 8), (128, 4), (128, 2), (128, 1), (16, 1)):
        ab1, bb1, nb1, bl1 = block_views(a, b, s1, bt1)
        two, fused = two_launches(ab1, bb1), fused_launch(ab1, bb1)
        t = [graph_ms(two, 20), graph_ms(fused, 20), graph_ms(fused, 20), graph_ms(two, 20)]
        e = [cuda_ms(two, 10), cuda_ms(fused, 10), cuda_ms(fused, 10), cuda_ms(two, 10)]
        by_nb[str(nb1)] = dict(
            block_len=bl1, fused_by_rule=linrec_mm.fuses_carries(nb1),
            b14_device_ms=graph_ms(lambda: linrec_mm.linrec_block_summaries(ab1, bb1), 20),
            fused_device_ms=(t[1] + t[2]) / 2, b14_then_b15_device_ms=(t[0] + t[3]) / 2,
            fused_ms=(e[1] + e[2]) / 2, b14_then_b15_ms=(e[0] + e[3]) / 2,
            bound_ms=bound(rows * n * 8 + rows * nb1 * 12)[0])
        del ab1, bb1
    out["B15"]["fused_by_nb"] = by_nb
    k, pl = paired_ms(fused_launch(ab, bb),
                      lambda: linrec_mm.linrec_summaries_carries_plain(ab, bb, f32), 5)
    bms, by = bound(rows * n * 8 + rows * nb * 12, rows * nb * 2)
    default, one_tile = by_nb[str(nb)], by_nb[str(nb1)]
    out["B14B15"] = dict(
        ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
        device_ms=default["fused_device_ms"], b14_then_b15_ms=default["b14_then_b15_ms"],
        b14_then_b15_device_ms=default["b14_then_b15_device_ms"],
        nb65536_ms=one_tile["fused_ms"], nb65536_device_ms=one_tile["fused_device_ms"],
        nb65536_b14_then_b15_ms=one_tile["b14_then_b15_ms"],
        nb65536_b14_then_b15_device_ms=one_tile["b14_then_b15_device_ms"],
        nb65536_bound_ms=one_tile["bound_ms"])
    cin = linrec_mm.linrec_carry_scan_plain(pp, pl_)
    k, pl = paired_ms(lambda: linrec_mm.linrec_block_scan_carry(ab, bb, cin),
                      lambda: linrec_mm.linrec_block_scan_carry_plain(ab, bb, cin, f32), 1,
                      kernel_reps=10)
    out["B16"] = dict(ms=k, plain_ms=pl, library_ms=None,
                      bound_ms=bound(rows * n * 12 + rows * nb * 4)[0], bound_by="bytes")
    k, pl = paired_ms(lambda: linear_scan(a, b, method="blocked"),
                      lambda: linrec_mm.linrec_blocked_scan_plain(a, b, s=128, block_tiles=8,
                                                                  acc=f32), 1, kernel_reps=10)
    out["linrec_pipeline"] = dict(ms=k, plain_ms=pl, library_ms=None,
                                  device_ms=graph_ms(lambda: linear_scan(a, b, method="blocked"),
                                                     10),
                                  bound_ms=bound(rows * n * 20)[0],     # B14's and B16's reads
                                  recurrence_bound_ms=bound(rows * n * 12)[0],
                                  vector_ms=cuda_ms(lambda: linear_scan(a, b, method="vector"),
                                                    2))
    del a, b, ab, bb
    # the SSD shape, (4, 16, 64, 64, 64) along axis 1 with the decay shared by each
    # (64, 64) state: the column walk that B13's and B16's launches there run, each
    # in turns with its plain version; beside it the path before it (the axis moved
    # last and the decay broadcast, copied to 2^20 rows of 16, one warp a row, and
    # moved back), and the whole linear_scan call as ssd_scan makes it
    sa, sb, ar, br = ssd_rows(gen, "random")
    nr, nn = ar.shape
    ssd = {"rows_bound_ms": bound(nr * nn * 12)[0]}
    for key, blocked in (("B13", False), ("B16", True)):
        k, pl = paired_ms(lambda bl=blocked: linrec_mm.linrec_columns(sa, sb, 1, blocked=bl),
                          lambda: linrec_mm.linrec_columns_plain(sa, sb, 1), 5)
        ssd[key] = dict(ms=k, plain_ms=pl, bound_ms=bound(sb.numel() * 8 + sa.numel() * 4)[0],
                        device_ms=graph_ms(lambda bl=blocked: linrec_mm.linrec_columns(
                            sa, sb, 1, blocked=bl), 20))
    # the mesh phase's train_dp walks: each rank's two rows of the batch
    sa2, sb2 = sa[:2], sb[:2]
    ssd["B16"]["mesh_rank"] = dict(
        shape=list(sb2.shape), ms=cuda_ms(lambda: linrec_mm.linrec_columns(sa2, sb2, 1,
                                                                           blocked=True), 5),
        bound_ms=bound(sb2.numel() * 8 + sa2.numel() * 4)[0])
    ssd["B13"]["rows_ms"] = cuda_ms(lambda: linrec_mm.linrec_scan_tiles(ar, br, s=16), 5)
    a4, b4 = ar.reshape(nr, 1, 1, nn), br.reshape(nr, 1, 1, nn)
    z = torch.zeros((nr, 1), device=DEV)
    ssd["B16"]["rows_ms"] = cuda_ms(lambda: linrec_mm.linrec_block_scan_carry(a4, b4, z), 5)
    ssd["rows_path_kernel_ms"] = cuda_ms(lambda: torch.movedim(linrec_mm.linrec_scan_tiles(
        torch.movedim(sa.expand(sb.shape), 1, -1), torch.movedim(sb, 1, -1), s=16), -1, 1), 5)
    for method in ("kernel", "blocked", "vector", "matmul"):
        ssd[f"linear_scan_{method}_ms"] = cuda_ms(
            lambda m=method: linear_scan(sa, sb, axis=1, method=m, tile_s=16), 5)
    out["ssd_shape"] = ssd
    return out


def time_b6_b17(gen):
    """B6 at (4, 2^24) fp32, R = 16, and B17 at zamba2's forward shape, each in turns
    with its plain version.  B6's ``library_ms`` is a stable argsort of the digits
    plus a gather of the payload (two calls, as B5's).  No PyTorch call computes
    B17's function, so its ``library_ms`` is None; beside it stands
    ``ssd_scan(method="kernel")`` (B1 + B13 and fp32 einsums) as the yardstick.

    B6's bound: payload and digits in, payload and index out, 16 B an element.
    B17's: x, b, c and y once (4 B each) and a once, against the operations the
    kernel issues for 2·(Q²N/2 + Q²P/2 + 2QNP) fp32 operations a chunk (the causal
    half of C Bᵀ and of the scores' product with X, C·state and Bᵀ X): three TF32
    products on the tensor cores for each fp32 one, at ``TF32_OPS_PER_S``.  Beside
    it the bytes with the handed-on states written and read once, and the same
    fp32 operations on the CUDA cores at ``FP32_OPS_PER_S``."""
    b, n = SCAN_SHAPE
    x = torch.randn(SCAN_SHAPE, generator=gen, device=DEV)
    d = torch.randint(0, B6_BUCKETS, SCAN_SHAPE, generator=gen, device=DEV,
                      dtype=torch.int32)

    def split(x, d, r):
        return lambda: split_mm.multi_split_tiles(x, d, num_buckets=r)

    def lib(x, d):
        return lambda: torch.gather(x, -1, torch.argsort(d, dim=-1, stable=True))

    k, pl = paired_ms(split(x, d, B6_BUCKETS),
                      lambda: split_mm.multi_split_plain(x, d, B6_BUCKETS), 2, kernel_reps=10)
    out = {"B6": dict(ms=k, plain_ms=pl, bound_ms=bound(b * n * 16)[0], bound_by="bytes",
                      library_ms=cuda_ms(lib(x, d), 5),
                      with_digit_reread_bound_ms=bound(b * n * 20)[0],
                      device_ms=graph_ms(split(x, d, B6_BUCKETS), 10))}
    for r in (10, 256):                                  # the other R of phase b6
        dr = torch.randint(0, r, SCAN_SHAPE, generator=gen, device=DEV, dtype=torch.int32)
        out["B6"][f"r{r}_ms"] = cuda_ms(split(x, dr, r), 10)
        out["B6"][f"r{r}_device_ms"] = graph_ms(split(x, dr, r), 10)
        out["B6"][f"r{r}_library_ms"] = cuda_ms(lib(x, dr), 2)
        del dr
    del x, d
    for dd in DIST_WORLDS:                               # dist_top_p_sample's vocab shards
        sh = (VOCAB_ROWS, VOCAB // dd)
        x = torch.randn(sh, generator=gen, device=DEV)
        d = torch.randint(0, B6_BUCKETS, sh, generator=gen, device=DEV, dtype=torch.int32)
        out["B6"][f"d{dd}_shard"] = dict(
            shape=list(sh), ms=cuda_ms(split(x, d, B6_BUCKETS), 50),
            device_ms=graph_ms(split(x, d, B6_BUCKETS), 200),
            bound_ms=bound(sh[0] * sh[1] * 16)[0], library_ms=cuda_ms(lib(x, d), 50))
    args = ssd_inputs(gen)
    bsz, s, h, p = args[0].shape
    nst, q = args[2].shape[-1], SSD["chunk"]
    nc = -(-s // q)
    macs = bsz * h * nc * (q * q * nst / 2 + q * q * p / 2 + 2 * q * nst * p)
    nbytes = 4 * (2 * bsz * s * h * p + 2 * bsz * s * h * nst + bsz * s * h)
    handed_on = 2 * 4 * bsz * h * (nc - 1) * nst * p      # the workspace's states, out and in
    bms, by = bound(nbytes, 3 * 2 * macs, TF32_OPS_PER_S)
    k, pl = paired_ms(lambda: ssd_chunk.ssd_chunk_scan(*args, chunk=q),
                      lambda: ssd_chunk.ssd_chunk_plain(*args, chunk=q), 3, kernel_reps=10)
    out["B17"] = dict(ms=k, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by,
                      bytes_bound_ms=bound(nbytes)[0],
                      bytes_with_workspace_bound_ms=bound(nbytes + handed_on)[0],
                      tensor_core_bound_ms=bound(0, 3 * 2 * macs, TF32_OPS_PER_S)[0],
                      fp32_ops_bound_ms=bound(0, 2 * macs)[0], flops=2 * macs,
                      ssd_scan_kernel_ms=cuda_ms(
                          lambda: ssd_scan(*args, chunk=q, scan_method="kernel"), 3))
    return out


def time_b7h(gen):
    """One B7h pass (radix 16) at (4, 2^22) int32 keys, the dist sort's shard at D = 4,
    in turns with its plain version, and at (4, 2^23), the shard at D = 2.  Its
    bound: a 4-byte key and a 4-byte index in and out, 16 B an element.
    ``library_ms`` is a stable ``torch.sort`` of the digits plus a ``bincount`` of
    them (two calls; the digits are taken beforehand and the payloads' gathers are
    left out)."""
    b, n = B7H_SHAPE
    keys = torch.randint(-(1 << 31), (1 << 31) - 1, B7H_SHAPE, generator=gen, device=DEV,
                         dtype=torch.int64).to(torch.int32)
    perm = torch.arange(n, dtype=torch.int32, device=DEV).expand(b, n).contiguous()
    k, pl = paired_ms(lambda: split_mm.radix_pass_multibit(keys, perm, shift=28, pass_bits=4,
                                                           with_counts=True),
                      lambda: split_mm.radix_pass_plain(keys, perm, shift=28, pass_bits=4,
                                                        with_counts=True), 5)
    digits = (keys.long() >> 28) & 15
    flat = (digits + (torch.arange(b, device=DEV)[:, None] << 4)).reshape(-1)

    def lib():
        torch.sort(digits, dim=-1, stable=True)
        torch.bincount(flat, minlength=b << 4)

    # the D = 2 shard, (4, 2^23)
    keys2 = torch.randint(-(1 << 31), (1 << 31) - 1, (b, 2 * n), generator=gen, device=DEV,
                          dtype=torch.int64).to(torch.int32)
    perm2 = torch.arange(2 * n, dtype=torch.int32, device=DEV).expand(b, 2 * n).contiguous()
    d2 = cuda_ms(lambda: split_mm.radix_pass_multibit(keys2, perm2, shift=28, pass_bits=4,
                                                      with_counts=True), 5)
    return {"B7h": dict(ms=k, plain_ms=pl, library_ms=cuda_ms(lib, 5),
                        bound_ms=bound(b * n * 16)[0], bound_by="bytes",
                        d2_shard_ms=d2, d2_shard_bound_ms=bound(b * 2 * n * 16)[0])}


def launches_by_shape(multisplit, linrec, zamba, forward, train, worlds, timing,
                      mesh) -> dict:
    """B6's, B13's, B16's and B17's launches on the main paths by the shape they ran
    at, each beside the kernel's ms and bound there (timing): the launches of the
    kernels line, split by path.  The SSD shape is zamba2's cross-chunk states at
    prefill and in the forward, (4, 16, 64, 64, 64) along axis 1 (the column
    walk)."""
    t, ssd = timing, timing["ssd_shape"]
    shard = {dd: [VOCAB_ROWS, VOCAB // dd] for dd in DIST_WORLDS}
    rows = {dd: [DIST_SHAPE[0], DIST_SHAPE[1] // dd] for dd in DIST_WORLDS}
    ssd_rows_ = list(SSD_ROWS)

    def at(launches, shape, ms, bound_ms, path):
        return {"launches": launches, "shape": shape, "ms": ms, "bound_ms": bound_ms,
                "path": path}

    out = {
        "B6": [at(multisplit["multi_split"], list(SCAN_SHAPE), t["B6"]["ms"],
                  t["B6"]["bound_ms"], "main_multisplit, R = 16")]
        + [at(worlds[dd]["multi_split"], shard[dd], t["B6"][f"d{dd}_shard"]["ms"],
              t["B6"][f"d{dd}_shard"]["bound_ms"],
              f"dist_top_p_sample, R = 16, world of {dd}") for dd in DIST_WORLDS],
        "B13": [at(linrec["linrec_scan"], list(SCAN_SHAPE), t["B13"]["ms"],
                   t["B13"]["bound_ms"], "main_linrec"),
                at(zamba["linrec_scan"], ssd_rows_, ssd["B13"]["ms"], ssd["B13"]["bound_ms"],
                   "serve_zamba2 prefill, scan_method='kernel'")]
        + [at(worlds[dd]["linrec_scan"], rows[dd], t["B13"][f"d{dd}_shard_ms"],
              t["B13"][f"d{dd}_shard_bound_ms"], f"dist_linear_scan, world of {dd}")
           for dd in DIST_WORLDS],
        "B16": [at(linrec["linrec_block_scan"], list(SCAN_SHAPE), t["B16"]["ms"],
                   t["B16"]["bound_ms"], "main_linrec"),
                at(zamba["linrec_block_scan"] + forward["linrec_block_scan"], ssd_rows_,
                   ssd["B16"]["ms"], ssd["B16"]["bound_ms"],
                   "serve_zamba2 prefill and forward_zamba2, scan_method='blocked'"),
                at(train["linrec_block_scan"], ssd_rows_, ssd["B16"]["ms"],
                   ssd["B16"]["bound_ms"], "phase_train, scan_method='auto': the forward, "
                   "its remat recompute and the adjoint"),
                at(mesh["linrec_block_scan"], ssd["B16"]["mesh_rank"]["shape"],
                   ssd["B16"]["mesh_rank"]["ms"], ssd["B16"]["mesh_rank"]["bound_ms"],
                   "phase_mesh train_dp, scan_method='auto', both ranks")]
        + [at(worlds[dd]["linrec_block_scan"], rows[dd], t[f"B16_d{dd}_shard"]["ms"],
              t[f"B16_d{dd}_shard"]["bound_ms"], f"dist_linear_scan, world of {dd}")
           for dd in DIST_WORLDS],
        "B17": [at(forward["ssd_chunk"], [SSD[k] for k in ("batch", "seq", "heads",
                                                            "head_dim", "state")],
                   t["B17"]["ms"], t["B17"]["bound_ms"], "forward_zamba2, scan_method='kernel'")],
    }
    for name, rows_ in out.items():
        total = sum(r["launches"] for r in rows_)
        check(total > 0, f"{name}: no launch on a main path")
        for r in rows_:
            r["launches_x_ms_over_bound"] = r["launches"] * (r["ms"] - r["bound_ms"])
    return {"phase": "launches_by_shape", **out}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_s = _build.build_all()
    emit({"phase": "build", "seconds": build_s, "libraries": sorted(_build.SOURCES),
          "flags": list(_build.NVCC_FLAGS)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # a default call that falls back to another backend's table fails the run
    warnings.simplefilter("error", AutotuneFallbackWarning)
    gen = torch.Generator(device=DEV).manual_seed(1234)
    b1_err = phase_b1(gen)
    b7_err = phase_b7(gen)
    b8_err = phase_b8(gen)
    b2b4_err = phase_b2b4(gen)
    b5_err = phase_b5(gen)
    seg_err = phase_seg(gen)
    lin_err = phase_linrec(gen)
    phase_guards(gen)
    scan_counts = main_scan(gen)
    blocked_counts = main_blocked(gen)
    segmented_counts = main_segmented(gen)
    linrec_counts = main_linrec(gen)
    phase_auto(gen, smi[0])
    phase_precision(smi[0])
    ref = smoke_reference(gen)
    emit({"phase": "smoke_reference", **ref})
    serve_counts, serve_b_counts, serve_s_counts, llama = main_serve(gen)
    auto_counts = auto_serving(llama, gen)["launches"]
    cont_counts = serve_continuous(llama)
    guards_serving(llama)
    del llama
    phase_ssd(gen)
    zamba_counts = serve_zamba2(gen)
    b6_err = phase_b6(gen)
    b17_err = phase_b17(gen)
    multisplit_counts = main_multisplit(gen)
    forward_counts = forward_zamba2(gen)
    train_counts = phase_train(gen)
    models_counts = phase_models(gen)
    families_counts = phase_families(gen)
    b7h_err = phase_b7h(gen)
    dist_counts, dist_sort_ms, dist_worlds = phase_dist()
    sharded_counts = phase_serve_sharded()
    mesh_counts = phase_mesh()
    phase_dryrun()
    examples_counts = phase_examples()
    timing = phase_timing(gen, dist_sort_ms)
    seg_launches = {k: segmented_counts[k] + serve_s_counts[k] + models_counts[k]
                    for k in ops.KERNELS}
    lin_launches = {k: linrec_counts[k] + zamba_counts[k] + forward_counts[k]
                    + train_counts[k] for k in ops.KERNELS}

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("B1 scan_tiles (ScanU/ScanUL1 tile scan; launches include zamba2 serving, "
         "xlstm-350m's forward, loss and serving under scan_method='kernel', and the "
         "mesh phase's expert-parallel deepseek-moe-16b dispatch, one a MoE layer a pass "
         "a rank)", "scan_mm.cu", "src/repro/kernels/scan_mm.py:36",
         scan_counts["scan_mm"] + zamba_counts["scan_mm"], b1_err, timing["B1"]),
        ("B2 block_partial_sums (block sums of the blocked pipeline)", "block_sums.cu",
         "src/repro/kernels/scan_pipeline.py:71", blocked_counts["block_sums"],
         b2b4_err["B2"], timing["B2"]),
        ("B3 carry_scan (exclusive scan of the block sums; launches: the pipeline's "
         "fused B2 launches, whose CTA that finishes a row runs B3's walk, carry_row.cuh; "
         "times: B3's own launch)", "carry_scan.cu",
         "src/repro/kernels/scan_pipeline.py:105",
         blocked_counts["carry_scan"] + blocked_counts["carry_walks"],
         max(b2b4_err["B3"], b2b4_err["B2B3"]), timing["B3"]),
        ("B4 block_scan_carry (block scan plus carry; launches include topp_blocked "
         "serving, zamba2 serving, zamba2 forward and loss, and xlstm-350m's forward, "
         "loss and serving under scan_method='blocked')", "block_scan.cu",
         "src/repro/kernels/scan_pipeline.py:143",
         blocked_counts["block_scan"] + serve_b_counts["block_scan"]
         + zamba_counts["block_scan"] + forward_counts["block_scan"], b2b4_err["B4"],
         timing["B4"]),
        ("B5 split_tiles (SplitInd; launches: compress on the blocked pipeline, and the "
         "continuous engines' page allocators, one an allocation: the topp_scan run's "
         "method='kernel', and the greedy run's 'auto' where the cuda table resolves "
         "129 pages to 'kernel')",
         "split.cu", "src/repro/kernels/split_mm.py:136",
         blocked_counts["split"] + cont_counts["split"], b5_err, timing["B5"]),
        ("B6 multi_split_tiles (stable R-way split, the tile split for R <= 511; times at "
         "(4, 2^24), R = 16; launches: multi_split(method='kernel') at (4, 2^24) and "
         "dist_top_p_sample's vocab shards at R = 16, (4, 32064) in the world of 4 and "
         "(4, 64128) in the world of 2)", "multi_split.cu", "src/repro/kernels/split_mm.py:194",
         multisplit_counts["multi_split"], float(b6_err), timing["B6"]),
        ("B7 radix_pass_multibit (radix-16 pass; times are the 4-pass bf16 sort chain and "
         "a stable torch.sort, eager; launches: topp_kernel "
         "serving of llama3-8b, zamba2, the models phase's four families and the "
         "families phase's four)",
         "radix_pass.cu", "src/repro/kernels/split_mm.py:262",
         serve_counts["radix_pass"] + zamba_counts["radix_pass"] + models_counts["radix_pass"],
         float(b7_err), timing["B7"]),
        ("B7h radix_pass_multibit(with_counts=True) (radix-16 pass exporting its digit "
         "histogram; launches: the dist phase's sorts and samplers, summed over the ranks "
         "of both worlds)", "radix_pass_hist.cu", "src/repro/kernels/split_mm.py:273", 0,
         float(b7h_err), timing["B7h"]),
        ("B8 topp_mask_sample_tiles (fused top-p tail; launches: topp_kernel serving, "
         "paligemma-3b's rows of 257216 included)", "topp_tail.cu",
         "src/repro/kernels/split_mm.py:360",
         serve_counts["topp_tail"] + zamba_counts["topp_tail"] + models_counts["topp_tail"],
         float(b8_err), timing["B8"]),
        ("B9 seg_scan_tiles (segmented tile scan; launches: segment_compress, "
         "topp_segmented serving and sample_packed under method_override('kernel'), and "
         "the MoE dispatch of deepseek-moe-16b and llama4-scout under "
         "scan_method='kernel': one a MoE layer a pass)",
         "seg_scan.cu", "src/repro/kernels/segscan_mm.py:186", seg_launches["seg_scan"],
         seg_err["B9"], timing["B9"]),
        ("B10 seg_block_summaries (trailing-segment sums and has-boundary per block; "
         "launches as B11 and B12, under method_override('blocked'))", "seg_summaries.cu",
         "src/repro/kernels/segscan_mm.py:252", seg_launches["seg_summaries"], seg_err["B10"],
         timing["B10"]),
        ("B11 seg_carry_scan (segmented exclusive scan of the block summaries)",
         "seg_carry.cu", "src/repro/kernels/segscan_mm.py:293", seg_launches["seg_carry"],
         seg_err["B11"], timing["B11"]),
        ("B12 seg_block_scan_carry (segmented block scan plus gated carry; launches also "
         "deepseek-moe-16b's MoE dispatch under scan_method='blocked', one block a row)",
         "seg_block_scan.cu", "src/repro/kernels/segscan_mm.py:325",
         seg_launches["seg_block_scan"], seg_err["B12"], timing["B12"]),
        ("B13 linrec_scan_tiles (linear-recurrence scan, a single pass with the affine "
         "look-back; times at (4, 2^24); launches: main_linrec, zamba2 prefill's "
         "(4, 16, 64, 64, 64) cross-chunk states on the column walk under "
         "scan_method='kernel', xlstm-350m's (4, 16, 4, 512, 512) and (4, 16, 4, 512, 1) "
         "ones (numerator and normaliser) in its forward, loss and prefill, and "
         "dist_linear_scan's shards)", "linrec_scan.cu",
         "src/repro/kernels/linrec_mm.py:72", lin_launches["linrec_scan"], lin_err["B13"],
         timing["B13"]),
        ("B14 linrec_block_summaries ((prod a, trailing sum) per block; launches include "
         "the pipeline's fused B14 + B15 launches)",
         "linrec_summaries.cu", "src/repro/kernels/linrec_mm.py:143",
         lin_launches["linrec_summaries"], lin_err["B14"], timing["B14"]),
        ("B15 linrec_carry_scan (exclusive affine scan of the block summaries; launches: "
         "the pipeline's fused B14 launches, whose CTA that finishes a row runs B15's "
         "walk, linrec_carry_row.cuh; times: B15's own launch)",
         "linrec_carry.cu", "src/repro/kernels/linrec_mm.py:183",
         lin_launches["linrec_carry"] + linrec_counts["carry_walks"],
         max(lin_err["B15"], lin_err["B14B15"]), timing["B15"]),
        ("B16 linrec_block_scan_carry (block recurrence seeded with its carry; launches: "
         "main_linrec, zamba2 prefill, zamba2 forward and loss, and xlstm-350m's "
         "forward, loss and prefill under scan_method='blocked', their cross-chunk "
         "states on the column walk; and zamba2-1.2b training on scan_method='auto', "
         "38 x 3 walks a step: the forward, its remat recompute and the adjoint, and "
         "in the mesh phase 12 x 3 a step a rank at 12 layers on two data ranks)",
         "linrec_block_scan.cu", "src/repro/kernels/linrec_mm.py:219",
         lin_launches["linrec_block_scan"], lin_err["B16"], timing["B16"]),
        ("B17 ssd_chunk_scan (chunked SSD scan, one CTA a chunk with the state handed "
         "on, 3xTF32 tensor-core products; launches: zamba2-1.2b forward and loss "
         "under scan_method='kernel', 38 a pass)", "ssd_chunk.cu",
         "src/repro/kernels/ssd_chunk.py:27", forward_counts["ssd_chunk"], b17_err,
         timing["B17"]),
    ]
    # every row also counts the dist phase's checked calls on every rank (the kernel
    # methods' scans, splits and passes), the topp_sharded run (none: "matmul"), the
    # topp_auto run (the auto phase's serving default, on the "cuda" table), the
    # families phase (xlstm's mLSTM scans, the four families' topp_kernel sampling)
    # and the mesh phase on both ranks (train_dp's B16 walks, serve_ep's B1 dispatch),
    # and the examples phase (the five examples/torch_*.py on the card)
    kernels = [dict(name=name, route="cuda", source=src + f, replaces=rep,
                    launches=n + dist_counts[f[:-3]] + sharded_counts[f[:-3]]
                    + auto_counts.get(f[:-3], 0) + families_counts[f[:-3]]
                    + mesh_counts[f[:-3]] + examples_counts[f[:-3]],
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])
               for name, f, rep, n, err, t in rows]
    check(all(k["launches"] > 0 for k in kernels),
          f"kernels launched no time on their main paths: "
          f"{[k['name'] for k in kernels if not k['launches']]}")
    emit(launches_by_shape(multisplit_counts, linrec_counts, zamba_counts, forward_counts,
                           train_counts, dist_worlds, timing, mesh_counts))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
