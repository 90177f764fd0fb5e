#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`geneevolve_tpu_torch`) once on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py biobank_1m_mesh2

The second form runs `biobank_1m` on one card and then at `--mesh ind=2`
on two gloo ranks sharing it (`biobank_mesh2_main`), and nothing else.
Phases of the first, each of which raises on failure (exit code
non-zero):

0. build: compile every kernel in `geneevolve_tpu_torch/csrc/` with nvcc
   for sm_90a, one nvcc per source, all at once (seconds printed);
1. kernels: each kernel against its plain PyTorch version on the card at
   main-path shapes, bit-exact (integer outputs), with median times from
   CUDA events taken in turns with the plain version and, where one
   PyTorch call computes the same function, that call (`library_ms`:
   `torch.searchsorted`, `torch.index_select` on the rows as stored and
   on the rows viewed as whole integer words; a yardstick the port never
   calls; these two kernels and their library calls, and each entry of
   the packed meiosis, are timed again with 10 calls queued between two
   events, `queued_ms`, where the device time shows through the wrapper's
   host time; the packed meiosis also prints the launch plan each entry
   used), and each kernel's bound
   (`bound_ms`: the larger of its bytes, each input read once and each
   output written once, over HBM's 3.35 TB/s and its operations over the
   scalar lanes' 67 T/s) and roofline share: the sampler's draws
   (`ops/point_draws`; its bound counts the uniforms a row's points read,
   and `library_ms` is the plain chain it replaced, `torch.cumsum`,
   `cdf_bins` and `_place`), the bins (on no path: the draws search
   inside their own kernel), the row gather, the count and the merge
   stacked over 22 chromosomes (and both parents) as the segment path
   launches them (n = 30,000 children, K ~ 5,000 map
   bins, 200-byte CV rows, S 49 ledger slots, 23 crossover slots), the
   gather also as one table, the count and the merge also at one
   chromosome; the gamete inheritance (`ops/gamete_inherit`) at the
   slice's in-place group shape (2 chromosomes x 30,708 gametes of one
   parent); the packed meiosis at the flagship shape (n 16,384 x 1 Mi loci,
   8 chromosomes) with and without mutations and in the split-plane
   layout, and at its odd twin (`flagship_odd`: 8 chromosomes of 4,095
   words, rows that are not whole 16-byte vectors); the byte meiosis at n
   4,096 x 1 Mi loci and at 8 chromosomes of 131,071 loci (`m_odd`: rows
   8 bytes off 16 every other row); each entry of kernels 4 and 5 prints
   its launch plan (`shifted`: parent planes read at a shift, `edges`:
   child rows cut into head, body and tail);
2. parity: the segment slice on `cuda` and on `cpu` (plain versions) on a
   small scenario, the CUDA run fed the CPU run's mating and reproduce
   plans; ledgers, mutations and resident CVs identical every generation;
3. slice: the middle row of the reference's Table 3.1 (pop_size 30,000,
   10,000 founders, 22 chromosomes, 100 CVs each, here 5 generations, plus
   a mutation map of ~1 de novo mutation per gamete per chromosome) through
   `geneevolve_tpu_torch.cli.main`, with the probe/real-pass slot
   tripwire, the outputs' shape and law, s/gen, the stage split, peak
   device memory (the run's, each generation's and each generation's
   parts: before the real pass, the real pass, the rest) beside the memory
   reckoning's need, and the stacked kernels' launches a generation (3
   draws, 1 count; in place, a group of 2 chromosomes at a time: 11
   merges, 44 gathers, 22 gamete inheritances); then those kernels
   against their plain versions on the last generation's own inputs (its
   parents' planes copied to the host before it, outside its timing),
   bit-exact: every launch that read the parents (the count, the 11
   merges, each equal to the children the run wrote over the parents, the
   44 gathers, and the 22 gamete inheritances on the rows those gathers
   made, each equal to the mutation and CV rows the run wrote;
   `_recheck`) and the 3
   draws launches, timed: the draws, the last group's gathers, the count,
   the merge of the last group and of every chromosome (both modes); then
   the paint kernel at full width on the slice's final
   ledgers and mutations (29,978 x 2 chromatid rows, S 49) over a
   synthetic 20,000-haplotype x 14,588-locus panel a chromosome (Table
   3.1's 320,926 SNPs over 22 chromosomes, some positions before the
   chromosome start, some at carried mutations): one chromosome against
   its plain version (run in row chunks on the card), bit-exact and timed,
   and all 22 in one launch, each chromosome bit-exact to the plain one
   (each paint entry also prints its launch plan, how many spans each of
   the kernel's paths painted, and a need bound that counts only the
   ledger and mutation slots before each row's first BIG);
3b. gather path: the same slice under GE_NO_RESIDENT_CV=1 (A/D painted
   from the ledger, 1 paint, 22 gathers, 3 draws, 1 count and 11 merge
   launches a generation), its `.info` and `.summary` byte-identical to the
   resident run's, s/gen, stage split and peak memory beside it; then the
   paint kernel at that path's shape (22 chromosomes x 100 CVs) on its
   last generation's own inputs, bit-exact, and every launch of that
   generation that read the parents, as the slice's;
3c. two populations (`multipop31`): the slice's shape twice (each
   10,000 founders, pop_size 30,000, 22 x 100 CVs, the slice's mutation
   map; population 2 from `tools/mkscenario.py` with the same seed, then
   fresh CV alleles and effects), 3 generations, migration `0.9 0.1 0.1
   0.9` and `--gamma 0.5`, `--checkpoint_every 2`: 40,000 founder haps, so
   int32 haps, on the gather path with each chromatid's root population
   painted over a root panel (M = 0); launches a generation and
   population (3 draws, 2 gathers, 1 count, 1 merge, 2 paints), each
   population's final ledger holding the other's founder haps, P means
   apart (gamma), the tripwire, the checkpoint's size and save seconds;
   then every launch of its last generation that read the parents (both
   populations; the last count and merge timed, int32 haps) and both
   paints against their plain versions on their own inputs, bit-exact;
   then a
   fresh `Simulation` resumed from its generation-2 checkpoint, its
   generation-3 `.info`/`.summary` byte-identical to the straight run's
   (load seconds); before it, a two-population cuda-vs-cpu parity at the
   parity phase's size (planes identical every generation, after
   migration too);
3b'. capacity grow (`grow31`): the slice's files for 3 generations with
   the ledger capacity S cut to 12 after loading, so that a generation
   pads the ledgers into new planes (`[capacity grow]`) before its
   in-place real pass: that generation's peak beside the others', the
   tripwire, launches as its capacity log says; its last generation's
   launches that read the parents re-checked as the slice's;
3c'. the biobank-n memory regime (after the two-population phases):
   `table31_300k`, Table 3.1's top row (pop_size 300,000) over the
   slice's scenario files, 3 generations, in place with the per-group
   plan (3 draws twice, 1 count, 1 merge and 4 gathers a group of 2
   chromosomes); `table31_300k_fresh`, the same under
   GE_NO_INPLACE_REPRO=1 GE_PLAN_PER_GROUP=0 (one stacked launch of each
   a kind), its `.info`/`.summary` byte-identical to `table31_300k`'s and
   its peak above it; `biobank_1m` (pop_size 1e6), with the largest
   population each path admits by the reckoning on 1, 2 and 4 'ind'
   ranks. Each prints s/gen, the
   stage split, its peaks beside the reckoned need and the reference's
   1,121.8 s/gen at 300,000; then every launch of the last generation
   that read the parents (each group's count, merge and gathers, or the
   fresh planes' stacked ones) at its full shape on its own inputs (the
   parents' planes copied to the host before that generation) against
   its plain version (in chunks of 2^20 chromosome and child rows), each
   merge equal to every row of the children the run wrote, the last of
   each and the draws of the last plan timed;
3d. segment output parity: a small segment scenario with `--out_hap
   --out_vcf --out_plink --out_interval --debug --file_output_generations`,
   then `--out_plink01`, then a `--file_ref_vcf` panel on both backends,
   each on `cuda` and on `cpu`, the CUDA run fed the CPU run's mating
   plans and draws: every genotype file byte-identical;
4. dense parity: `--backend dense` with hap/VCF/PLINK output on `cuda`
   and on `cpu`, the CUDA run fed the CPU run's mating plans and draws:
   planes and CV matrices equal every generation, genotype files
   byte-identical; over 256 SNPs a chromosome (8 words) and over 200
   (`dense_parity_odd`: padded to 224 loci, 7 words);
5. dense slice: Table 3.1's shape with a 2,000-founder x 2,048-SNP panel
   per chromosome through `cli.main --backend dense`, with the same checks,
   one packed-meiosis launch per generation and the resident CV matrices
   equal to the planes' CVs at the end; then the packed meiosis and the CV
   row gather against their plain versions on the last generation's own
   inputs (22 chromosomes of 64 words, 4,400-byte CV rows), bit-exact;
5a. `dense_odd31`: the dense slice over 2,000 SNPs a chromosome (padded
   to 2,016 loci, 63 words: kernel 4 cuts every child row into head, body
   and tail and reads the B planes, at +1,386 words, shifted), 3
   generations with the same checks; its s/gen beside dense31's; then the
   packed meiosis on its last generation's own inputs, bit-exact (the
   `dense_odd` entry);
5b. dense mutations: the dense slice again for 3 generations with a
   mutation map of rate 1 in every bin (~0.9 de novo mutations a gamete
   on the dense law, where the slice's own map gives 4.3e-4): the mean
   realized count a gamete in [0.5, 2], the resident CVs equal to the
   planes' CVs, and the packed meiosis bit-exact on its last generation's
   inputs, its flips changing the children;
5c. dense two populations (`dense_multipop31`): the dense slice's shape
   twice at identical loci (population 2 with fresh panel alleles and
   effects, its CVs on its own panel's sites), 3 generations, migration
   and gamma: each population's resident CVs equal its planes', one
   packed meiosis a generation and population;
6. packed engine: `dense.packed.make_step` at the flagship shape, 1 warm-up
   and 5 timed generations, the resident CV matrix checked against the
   planes at the end; then the same at 8 chromosomes of 4,095 words
   (`packed_engine_odd`), its ind.loci.gens/s beside the aligned step's;
7. byte engine: `dense.step.make_step` against `dense.packed.make_step`
   at n 4,096 x 1 Mi loci, 2 generations from identically seeded
   generators, equal after unpacking;
8. segment output at full width: the CLI on the segment backend over the
   dense slice's scenario files (30,000 pop, 2,000 founders, 22 x 2,048
   SNPs), 3 generations, `--out_vcf --out_interval` at generation 3
   (`--file_output_generations`): file and line counts, VCF samples, the
   `.int` chains, the tripwire in `merge_ibd=False` mode, the output
   stage split into paint (fenced), device-to-host copy and text writing;
   the files are deleted after the checks;
9. profile: one generation of the resident slice under `--profile`; the
   trace's top device ops and the device's busy share of the generation;
10. device mating (`segment_device_mating`): the segment slice again under
   `--device_mating --avoid_inbreeding`, its schedule's mating correlation
   0.3: the stacked kernels' launches a generation, the tripwire, from
   generation 2 on each generation's realized couple correlation of
   mating values within 0.05 of 0.3, no vetoed couple with a child; s/gen
   and its `mate` stage beside the resident slice's host `mate` stage;
   its last generation's launches that read the parents re-checked as the
   slice's;
11. device mating parity: `assort_mate_device` at 30,000 individuals on
   the card and on the CPU from the same draws (drawn on the CPU and
   moved), under the "p" law, the "f" law and MM 0.2 with the veto on:
   identical plans; the card's pairing, CPU torch's and the host numpy
   `assort_mate` timed;
12. dense device mating (`dense_device_mating`): the dense slice under
   `--device_mating`, 3 generations: one packed meiosis and two CV-row
   gathers a generation, resident CVs equal to the planes'; s/gen and the
   `mate` stage;
13. the dense scenario CLI (`python -m geneevolve_tpu_torch.dense.scenario`,
   in this process through `main`): first a cuda-vs-cpu parity with
   `--out_hap` at the dense parity phase's size, the card fed the CPU
   run's draws (`.hap`/`.indv` byte-identical); then `scenario31` over the
   dense slice's panel, map and CVs (bootstrapped to 30,000, selection,
   `--mut_rate 1.0`, 5 generations, a checkpoint every 2): one packed
   meiosis and two CV-row gathers a generation, resident CVs equal to the
   planes', s/gen; then `scenario31_resume` from the generation-4
   checkpoint to generation 5, its final planes and CVs equal to the
   straight run's on the card;
14. streamed engine (`streamed`, after the packed engine): the flagship
   shape without CVs, one chromosome a slab (8 slabs of 512 MiB, 4 GiB
   pinned host memory, `/proc/meminfo`'s MemAvailable printed and
   checked first), 1 warm-up and 3 timed generations: 8 packed meiosis
   launches a generation, the first generation bit-exact against the
   same kernel on device-resident copies of the founder slabs (after the
   counted run), h2d / d2h copy seconds a generation, ind.loci.gens/s
   beside the packed engine's;
15. the mesh (after the two-population phases and the dense slice):
   `segment_mesh1`, the
   slice through the CLI's `--mesh ind=1` joined to a one-rank NCCL group
   as under torchrun (`.info`/`.summary` byte-identical to table31's, its
   launches a generation as `SEGMENT_PER_GEN`, s/gen and exchange beside
   it; its last generation's launches that read the parents re-checked as
   the slice's); `packed_mesh1` on the same group: the flagship through
   `make_sharded_step` bit-identical to `dense.packed.make_step`, one
   generation each of `make_deme_step` (ring migration) and
   `make_routed_step` (overflow 0), and the byte step (n 4,096) through
   `make_sharded_step(DenseConfig)` bit-identical to `dense.step.make_step`;
   then `multipop31` without `--gamma` unsharded, and two ranks sharing
   the card over gloo (`parallel.launch`, `backend="gloo"`), each counting
   its own launches: `segment_mesh2` (the slice, 3 generations, files
   byte-identical to table31's first 3, in place on both ranks as on one
   card: a group's parent rows fetched at a time; its peak a rank below
   table31's), `multipop_mesh2` (files byte-identical to the unsharded
   run's; launches as its capacity log says), `table31_300k_mesh2`
   (`table31_300k`'s files, kept for it, 3 generations; files
   byte-identical, launches as `PER_GROUP_PER_GEN`), each segment run with
   every rank's peaks before, in and after each real pass beside its
   reckoned need, which the peak must not pass, and the last
   generation's last launches of the stacked kernels held to their plain
   versions on their own inputs (`_MeshLaunches`), and `packed_mesh2` (the three
   steps at n 4,096 x 1 Mi loci at (ind, loci) = (2, 1) and (1, 2), and
   the sharded step at (1, 2) over 7 chromosomes of 131,072 loci, each
   rank holding 3.5 of them: kernel 4's window entry once a piece,
   bit-identical to the one-rank step); per rank s/gen, exchange bytes
   and seconds a generation and peak memory; on each path every kernel's
   last call is held against its plain version after the counted run.
   The dense backend: `dense_mesh1`, the dense slice through `--mesh
   ind=1` on the one-rank NCCL group (`.info`/`.summary` byte-identical
   to dense31's, s/gen and peak beside it), and `dense_mesh2` in the
   two-rank launch, at `--mesh ind=2` and `ind=1,loci=2`, 3 generations
   each, files byte-identical to dense31's first 3 generations. The
   kernel phase also times kernel 4's window entry (whole chromosomes,
   half a chromosome, a window at an odd word) beside the whole-plane
   launch.

Every path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that never launched fails the run. Each
kernel's `launches` and `launches_per_gen` are those of its home path
(`HOME_PATH`). Prints the card's name and power limit, then one JSON line
of kernel results, then, last, `{"ok": true, "device": {...}}`. Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_CHILD = 30_000
SCENARIO = dict(n0=10_000, pop_size=30_000, gens=5, nchr=22, ncv=100)
# the dense slice: the same shape over a real 2,000 x 2,048-SNP panel,
# its CVs on panel sites (so the resident CVs must equal the planes').
# Its variances are set (h2 = 0.5 at gen 0): with the raw effects (var_A
# ~1,100) beside ve = 1, the sampling covariance of A and E at 2,000
# founders (sd ~1.5) puts h2 above 1 about one run in four.
DENSE_SCENARIO = dict(n0=2_000, pop_size=30_000, gens=5, nchr=22, ncv=100,
                      snps=2_048, cvs_on_panel=True)
DENSE_VARIANCES = ["--va", "0.5", "--ve", "0.5"]
# the dense slice over 2,000 SNPs a chromosome: padded to 2,016 loci, 63
# words, so its child rows take heads, tails and shifted parent planes
DENSE_ODD_SNPS = 2_000
DENSE_ODD_GENS = 3
KERNELS = {  # name -> (source, TPU function it replaces)
    "cdf_bins": ("geneevolve_tpu_torch/csrc/cdf_bins.cu",
                 "geneevolve_tpu/ops/cdf_bins_pallas.py:119"),
    "merge_count": ("geneevolve_tpu_torch/csrc/merge_count.cu",
                    "geneevolve_tpu/ops/merge_count_pallas.py:90"),
    "gather_rows": ("geneevolve_tpu_torch/csrc/gather_rows.cu",
                    "geneevolve_tpu/ops/materialize.py:72"),
    "meiose_merge": ("geneevolve_tpu_torch/csrc/meiose_merge.cu",
                     "geneevolve_tpu/core/segments.py:749"),
    # new: port no TPU kernel (XLA chains in the JAX package)
    "point_draws": ("geneevolve_tpu_torch/csrc/point_draws.cu",
                    "geneevolve_tpu/core/segments.py:444 (XLA; no TPU "
                    "kernel)"),
    "gamete_inherit": ("geneevolve_tpu_torch/csrc/gamete_inherit.cu",
                       "geneevolve_tpu/core/segments.py:855 and "
                       "geneevolve_tpu/core/engine.py:422 (XLA; no TPU "
                       "kernel)"),
    "meiose_packed": ("geneevolve_tpu_torch/csrc/meiose_packed.cu",
                      "geneevolve_tpu/ops/meiosis_packed_pallas.py:146"),
    "meiose_planes": ("geneevolve_tpu_torch/csrc/meiose_planes.cu",
                      "geneevolve_tpu/ops/meiosis_pallas.py:77"),
    "paint": ("geneevolve_tpu_torch/csrc/paint.cu",
              "geneevolve_tpu/core/output.py:33"),
}
# the packed kernel's other entries: the TPU layout experiments it replaces
PACKED_ENTRIES = {"no_mutations": "tools/kexp.py:178",
                  "split_planes": "tools/kexp.py:110"}
# the flagship packed configuration (bench.py:200-211)
FLAGSHIP = dict(n=16_384, m=1 << 20, n_chr=8, morgans_per_chr=1.0, xo_cap=8,
                mut_rate=1.0, mut_cap=8, ncv=256, selection=True)
BYTE_N = 4096  # byte-engine rows: 2 x 4 GiB of uint8 planes at 1 Mi loci
# the flagship's odd twins: 8 chromosomes of 131,040 loci (4,095 words) for
# the packed kernel and step, 8 of 131,071 loci (m % 16 = 8) for the byte
# kernel
FLAGSHIP_ODD = dict(FLAGSHIP, m=8 * 131_040)
BYTE_ODD_M = 8 * 131_071
# each path: the kernels it must launch; its counts are read after it runs
SEGMENT_LEDGER = ("point_draws", "merge_count", "gather_rows",
                  "meiose_merge")
SEGMENT = SEGMENT_LEDGER + ("gamete_inherit",)
PATHS = {
    "segment_slice": SEGMENT,
    "segment_gather": SEGMENT + ("paint",),
    "segment_multipop": SEGMENT + ("paint",),
    "segment_multipop_resume": SEGMENT + ("paint",),
    "dense_multipop": ("meiose_packed", "gather_rows"),
    "segment_output": SEGMENT_LEDGER + ("paint",),
    "segment_profiled": SEGMENT,
    "dense_slice": ("meiose_packed", "gather_rows"),
    "dense_odd": ("meiose_packed", "gather_rows"),
    "dense_mutations": ("meiose_packed", "gather_rows"),
    "packed_engine": ("meiose_packed", "gather_rows"),
    "packed_engine_odd": ("meiose_packed", "gather_rows"),
    "byte_engine": ("meiose_planes", "meiose_packed"),
    "segment_device_mating": SEGMENT,
    "dense_device_mating": ("meiose_packed", "gather_rows"),
    "scenario31": ("meiose_packed", "gather_rows"),
    "scenario31_resume": ("meiose_packed", "gather_rows"),
    "streamed": ("meiose_packed",),
    "grow31": SEGMENT,
    "table31_300k": SEGMENT,
    "table31_300k_fresh": SEGMENT,
    "biobank_1m": SEGMENT,
    "segment_mesh1": SEGMENT,
    "packed_mesh1": ("meiose_packed", "gather_rows", "meiose_planes"),
    "segment_mesh2": SEGMENT,
    "multipop_mesh2": SEGMENT + ("paint",),
    "table31_300k_mesh2": SEGMENT,
    "packed_mesh2": ("meiose_packed", "gather_rows"),
    "dense_mesh1": ("meiose_packed", "gather_rows"),
    "dense_mesh2": ("meiose_packed", "gather_rows"),
}
HOME_PATH = {"cdf_bins": "segment_slice", "point_draws": "segment_slice",
             "merge_count": "segment_slice",
             "gather_rows": "segment_slice", "meiose_merge": "segment_slice",
             "gamete_inherit": "segment_slice",
             "meiose_packed": "dense_slice", "meiose_planes": "byte_engine",
             "paint": "segment_gather"}
# launches a generation of the segment slice's stacked kernels on fresh
# planes: one draws launch per kind of draw (father's and mother's
# crossovers, mutations), one gather per parent and table (CV rows,
# mutation rows), one count (the probe) and one merge (the real pass) over
# every chromosome and parent, one gamete inheritance a parent
SEGMENT_FRESH_PER_GEN = {"point_draws": 3, "gather_rows": 4,
                         "merge_count": 1,
                         "meiose_merge": 1, "gamete_inherit": 2}
# in place (every constant-size generation on one 'ind' rank): the real
# pass a group of 2 chromosomes at a time, one merge, 4 gathers and 2
# gamete inheritances a group
GROUPS = 22 // 2
SEGMENT_PER_GEN = dict(SEGMENT_FRESH_PER_GEN, gather_rows=4 * GROUPS,
                       meiose_merge=GROUPS, gamete_inherit=2 * GROUPS)
# past 1.5e9 bytes of plan (300,000 and 1e6 here) the probe draws and
# counts a group at a time, and the real pass draws each group's plan
# again: 3 draws launches a group twice, one count a group
PER_GROUP_PER_GEN = dict(SEGMENT_PER_GEN, point_draws=2 * 3 * GROUPS,
                         merge_count=GROUPS)
# the gather path: no CV-row gathers; one paint a phenotype (one here) and
# generation, and one more for generation 0's A/D
GATHER_FRESH_PER_GEN = {"point_draws": 3, "gather_rows": 2,
                        "merge_count": 1,
                        "meiose_merge": 1, "gamete_inherit": 2, "paint": 1}
GATHER_PER_GEN = dict(GATHER_FRESH_PER_GEN, gather_rows=2 * GROUPS,
                      meiose_merge=GROUPS, gamete_inherit=2 * GROUPS)
# two populations (gather path), a generation and population: the gather
# path's launches with two paints a phenotype (alleles, then roots over the
# root panel with an empty mutation plane); one packed meiosis (dense)
MULTIPOP = 2
MULTIPOP_GENS = 3
# (in place only where a generation's children fit the rows the
# migration left: `_launches_from_log`)
DENSE_MULTIPOP_PER_GEN = {"meiose_packed": MULTIPOP}
# the biobank-n phases: Table 3.1's top row (pop_size 300,000, in place
# and on fresh planes) and 1e6, over the slice's scenario files, 3
# generations each; the kernels re-checked at full shape on the last
# generation's own inputs (its parents' planes copied to the host before
# it)
BIOBANK_GENS = 3
BIOBANK = {"table31_300k": 300_000, "table31_300k_fresh": 300_000,
           "biobank_1m": 1_000_000}
# the reference's own s/gen at 300,000 (BASELINE.md:11-23)
REFERENCE_300K_S = 1121.8
# the capacity-grow run: the slice's files with S cut to 12 after loading
# (a generation's gametes need up to ~15 slots), 3 generations
GROW_GENS = 3
GROW_S_CAP = 12
# the dense engines a generation: one packed meiosis, one CV-row gather a
# gamete (the packed step's `cv_child`, the dense backend's)
DENSE_PER_GEN = {"meiose_packed": 1, "gather_rows": 2}
# device mating: the mating correlation written into the schedule, and how
# far a generation's realized couple correlation may lie from it (~6
# standard errors at ~15,000 couples)
MAT_COR = 0.3
MAT_COR_TOL = 0.05
DENSE_DM_GENS = 3
# the dense scenario CLI: generations of the straight run (a checkpoint
# every 2, the resumed run from the last one)
SCENARIO_GENS = 5
# the streamed engine: one chromosome a slab of the flagship's 8, 1 warm-up
# and 3 timed generations
STREAMED_SLABS = FLAGSHIP["n_chr"]
STREAMED_TIMED = 3
# launches of generation 0's A/D, by path
GEN0_LAUNCHES = {"segment_gather": {"paint": 1},
                 "segment_multipop": {"paint": 2 * MULTIPOP}}
# the synthetic founder panel of the full-width paint check: 20,000
# haplotypes (the slice's 10,000 founders) x Table 3.1's 320,926 SNPs over
# 22 chromosomes (BASELINE.md:13), 14,588 a chromosome
PAINT_LOCI = -(-320_926 // 22)
# the full-width output run: the dense slice's scenario files, 3 generations
OUTPUT_GENS = 3
# the dense run with ~1 de novo mutation a gamete
DENSE_MUT_GENS = 3
# generations each counted path runs (packed engine: 1 warm-up + 5 timed)
PATH_GENS = {"segment_slice": SCENARIO["gens"],
             "segment_gather": SCENARIO["gens"], "segment_output": OUTPUT_GENS,
             "segment_multipop": MULTIPOP_GENS,
             "segment_multipop_resume": 1,  # generation 3, from generation 2
             "dense_multipop": MULTIPOP_GENS,
             "segment_profiled": 1,
             "dense_slice": DENSE_SCENARIO["gens"],
             "dense_odd": DENSE_ODD_GENS,
             "dense_mutations": DENSE_MUT_GENS, "packed_engine": 6,
             "packed_engine_odd": 6,
             "byte_engine": 2, "segment_device_mating": SCENARIO["gens"],
             "dense_device_mating": DENSE_DM_GENS,
             "scenario31": SCENARIO_GENS, "scenario31_resume": 1,
             "streamed": 1 + STREAMED_TIMED,
             "grow31": GROW_GENS,
             **{k: BIOBANK_GENS for k in BIOBANK}}
# the mesh paths: generations of the two-rank segment runs, and the rows of
# the two-rank packed steps (the flagship's 16,384 cut to 4,096: two ranks
# share one card and stage their exchanges through host memory)
MESH_GENS = 3
MESH_N = 4096
MESH_TIMEOUT_S = 600
# `table31_300k` on the two ranks (3 generations): its own share of the
# launch's time limit
BIG_MESH_TIMEOUT_S = 300
# host memory `biobank_1m_mesh2` asks to be available (GiB): the two
# ranks' pinned staging of a group's exchange (~2 GB each) beside the
# one-card run's host state
BIOBANK_MESH_HOST_GIB = 40
# `segment_mesh2`'s peak a rank when every generation fetched the whole
# generation's parent rows onto fresh planes (this smoke before the
# mesh ran in place, PERF.md §5; H100 80GB HBM3, 700 W)
SEGMENT_MESH2_FRESH_MB = 1529.0
# the sharded step over chromosomes a loci axis of 2 cuts in half: 7 of
# the flagship's 131,072-locus chromosomes, 3.5 a rank (two window
# launches of kernel 4 a rank: 3 whole chromosomes, half of one)
SPLIT = dict(FLAGSHIP, m=7 * (1 << 17), n_chr=7, n=MESH_N)
# launches of kernel 4's and kernel 5's window entries, by path
WINDOW_LAUNCHES: dict = {}
# H100 SXM data sheet at 700 W: HBM3 bytes/s, and the float32 rate outside
# the tensor cores, taken as the scalar-lane rate for the kernels' integer
# compares (the int32 lanes are no faster, so the bound stays a least time)
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def _wrappers():
    from geneevolve_tpu_torch.ops.cdf_bins import cdf_bins
    from geneevolve_tpu_torch.ops.gamete_inherit import gamete_inherit
    from geneevolve_tpu_torch.ops.materialize import gather_rows
    from geneevolve_tpu_torch.ops.meiose_merge import meiose_merge
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed
    from geneevolve_tpu_torch.ops.meiose_planes import meiose_planes
    from geneevolve_tpu_torch.ops.merge_count import merge_count
    from geneevolve_tpu_torch.ops.paint import paint
    from geneevolve_tpu_torch.ops.point_draws import point_draws

    return dict(cdf_bins=cdf_bins, point_draws=point_draws,
                merge_count=merge_count,
                gather_rows=gather_rows, meiose_merge=meiose_merge,
                gamete_inherit=gamete_inherit,
                meiose_packed=meiose_packed, meiose_planes=meiose_planes,
                paint=paint)


def _windows():
    """The window entries of kernels 4 and 5, whose launches also count
    as their kernel's."""
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed_window
    from geneevolve_tpu_torch.ops.meiose_planes import meiose_planes_window

    return dict(meiose_packed=meiose_packed_window,
                meiose_planes=meiose_planes_window)


def counted(path: str, wrappers: dict, fn, launches: dict):
    """Run `fn()` with every launch count set to 0 just before it; record
    the counts just after in `launches[path]`, and fail if a kernel of the
    path never launched."""
    import torch

    for w in wrappers.values():
        w.launches = 0
    for w in _windows().values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches[path] = {k: w.launches for k, w in wrappers.items()}
    WINDOW_LAUNCHES[path] = {k: w.launches for k, w in _windows().items()}
    idle = [k for k in PATHS[path] if launches[path][k] <= 0]
    if idle:
        raise AssertionError(f"{path}: kernels never launched: {idle}")
    print(f" {path}: launches {json.dumps(launches[path])}")
    return out


def _time_turns(fns: dict, reps: dict) -> dict:
    """Median ms of each `fns[k]()` over `reps[k]` runs (CUDA events), the
    functions timed in turns, forward then backward, after one warm-up
    each, so that a drift of the card's clock hits them alike."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(max(reps.values())):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            if len(times[k]) >= reps[k]:
                continue
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _rows_read(table, *idx, axis=0) -> int:
    """Bytes of the distinct rows of `table` along `axis` (1 for stacked
    tables, whose axis 0 is the batch) that the indices name: what a
    gather must read once."""
    import torch

    rows = torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel()
    return rows * _nbytes(table) // table.shape[axis]


def _bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the scalar lanes' rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / SCALAR_OPS_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes=nbytes, ops=ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _log2(x: int) -> int:
    return max(int(x - 1).bit_length(), 1)


def _bins_work(u, cum) -> dict:
    # probes in and bins out once, the CDFs once; a binary search a probe
    return _bound(_nbytes(u, cum) + 4 * u.numel(),
                  2 * u.numel() * _log2(cum.shape[-1]))


def _draws_work(counts, unif, v, cum, bp, width, live, inclusive, bp0=None,
                bp_step=None) -> dict:
    # what the points need, read once: a row's count, its uniforms up to
    # slot k and within-bin uniforms up to k - 1 (k its clipped count),
    # the CDFs (and anchor tables) once; every position written once. A
    # binary search of the CDF a point
    import torch

    C, n, cap = v.shape
    k = counts.clamp_max(cap)[torch.as_tensor(live, device=counts.device)]
    points = int(k.sum())
    reads = 4 * (int(k.numel()) + 2 * points + int(k.numel())) + _nbytes(cum)
    reads += 0 if bp0 is not None else _nbytes(bp)
    return _bound(reads + 4 * C * n * cap,
                  2 * points * _log2(cum.shape[-1]))


def _draws_library(args) -> dict:
    """The chain the kernel replaced: `torch.cumsum`, `cdf_bins` and
    `_place` a chromosome at a time (the plain version, run on the card)."""
    from geneevolve_tpu_torch.ops import point_draws as pd

    return {"cumsum_cdf_bins_place": lambda: pd.point_draws_plain(*args)}


def _gather_work(table, idx, axis) -> dict:
    # the distinct rows named read once, every gathered row written once
    out = idx.numel() * _nbytes(table) // table.shape[axis]
    return _bound(_rows_read(table, idx, axis=axis) + _nbytes(idx) + out, 0)


def _count_work(seg_st, parents, xo_f, xo_m, sh) -> dict:
    # the distinct parent rows of every chromosome read once, crossover
    # rows and starts once, a count a gamete written; a binary search over
    # the sorted crossovers a slot and a crossover
    gametes = 2 * xo_f.shape[0] * xo_f.shape[1]
    S, K = seg_st.shape[-1], xo_f.shape[-1]
    return _bound(_rows_read(seg_st, parents, axis=1)
                  + _nbytes(parents, xo_f, xo_m, sh) + 4 * gametes,
                  gametes * (2 * S + K) * _log2(K + 1))


def _merge_work(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap) -> dict:
    # as the count, plus the parents' hap rows and the child rows written;
    # a binary search over the merged candidates a candidate
    gametes = 2 * xo_f.shape[0] * xo_f.shape[1]
    S, K = seg_st.shape[-1], xo_f.shape[-1]
    return _bound(_rows_read(seg_st, parents, axis=1)
                  + _rows_read(seg_hap, parents, axis=1)
                  + _nbytes(parents, xo_f, xo_m, sh)
                  + gametes * (cap * (4 + seg_hap.element_size()) + 4),
                  gametes * (K + 2 * S) * _log2(K + 2 * S))


def _inherit_work(pm, cv, xo, start, new, q, out_mut, out_cv) -> dict:
    # each operand read once (a chromosome's CV positions once), each
    # output row and count written once; the rank sorts of the crossovers
    # and de novo slots, a binary search of the crossovers and of the other
    # two lists for each parent mutation, de novo entry and CV
    gametes = xo.shape[0] * xo.shape[1]
    K = xo.shape[-1]
    mn = new.shape[-1] if pm is not None else 0
    Mp = pm.shape[-1] if pm is not None else 0
    C = cv.shape[-1] if cv is not None else 0
    out = gametes * (4 * (out_mut.shape[-1] + 1) if pm is not None else 0)
    out += gametes * C
    reads = _nbytes(pm, cv, xo, q if cv is not None else None) + 4 * gametes
    reads += _nbytes(new) if pm is not None else 0
    search = _log2(K) + 2 * _log2(max(Mp, 2)) + _log2(max(mn, 2))
    return _bound(reads + out, gametes * (K * K + mn * mn
                                          + (2 * Mp + mn + C) * search))


def _packed_need(rows: int, args, n_chr: int, chr_len: int,
                 chunk=2048) -> int:
    """Bytes of parent words the packed meiosis must read for these inputs
    (`args`: fathers, mothers, xo_p, st_p, xo_m, st_m): each (parent row,
    plane, word) that some gamete takes a bit from, read once. A word whose
    phase mask is all zeros takes plane A only, all ones plane B only."""
    import torch

    from geneevolve_tpu_torch.dense import packed

    cfg = packed.PackedConfig(n=0, m=n_chr * chr_len, n_chr=n_chr)
    fathers, mothers, xo_p, st_p, xo_m, st_m = args[:6]
    need = torch.zeros((2, rows, cfg.mw), dtype=torch.int32,
                       device=fathers.device)
    for par, xo, st in ((fathers, xo_p, st_p), (mothers, xo_m, st_m)):
        for i in range(0, par.shape[0], chunk):
            mask = packed.phase_word_masks(xo[i:i + chunk], st[i:i + chunk],
                                           cfg)
            idx = par[i:i + chunk].long()
            need[0].index_add_(0, idx, (mask != -1).int())
            need[1].index_add_(0, idx, (mask != 0).int())
    return 4 * int((need > 0).sum())


def _packed_work(need: int, args, mu, n_chr: int, chr_len: int) -> dict:
    """The packed meiosis's bound: the parent words it must read (`need`,
    `_packed_need`'s bytes), the plan once, the child words written once;
    one select (and, andnot, or) a child word. `full_rows_bound_ms`: the
    same with both planes of every distinct parent row."""
    import torch

    n, mw = args[0].shape[0], n_chr * chr_len // 32
    out_b = 2 * n * mw * 4
    rest = _nbytes(*args[:6], mu) + out_b
    work = _bound(need + rest, 3 * out_b)
    full = torch.unique(torch.cat(args[:2])).numel() * 2 * mw * 4
    work["full_rows_bound_ms"] = _bound(full + rest, 3 * out_b)["bound_ms"]
    return work


def _gather_library(table, idx, axis) -> dict:
    """`torch.index_select` of the rows as the table holds them, and of
    the same rows viewed as their widest whole integer words (8, 4, 2 or 1
    bytes): for byte rows the first indexes element by element."""
    import torch

    rows = table.reshape(table.shape[:axis + 1] + (-1,))
    nbytes = rows.shape[-1] * rows.element_size()
    word, size = next((dt, w) for dt, w in (
        ("int64", 8), ("int32", 4), ("int16", 2), ("uint8", 1))
        if nbytes % w == 0)
    words = rows.view(torch.uint8).view(getattr(torch, word))
    return {"index_select": lambda: torch.index_select(table, axis, idx),
            f"index_select_{word}":
                lambda: torch.index_select(words, axis, idx)}


def _max_abs_err(got, want) -> int:
    """Largest |got - want| over the elements that differ (integer
    outputs; 0 when equal), without widening whole planes."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        ne = g != w
        if bool(ne.any()):
            err = max(err, int((g[ne].long() - w[ne].long()).abs().max()))
    torch.cuda.synchronize()
    return err


def _compare(name: str, kern, plain, work: dict, library=None,
             reps_plain=3, queued=False) -> dict:
    """`kern()` bit-exact to `plain()`, then the median ms of the kernel,
    the plain version and each one-call library yardstick in `library`
    (name -> call), timed in turns; `library_ms` is the fastest of those.
    `work` is `_bound`'s dict for these inputs. With a library, or with
    `queued`, the kernel (and the library) is also timed with 10 calls
    queued (`queued_ms`)."""
    err = _max_abs_err(kern(), plain())
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain by {err}")
    library = library or {}
    fns, reps = {"ms": kern, "plain_ms": plain}, {"ms": 20,
                                                  "plain_ms": reps_plain}
    fns.update(library)
    reps.update(dict.fromkeys(library, 20))
    t = _time_turns(fns, reps)
    r = dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], **work)
    r["library_calls"] = {k: t[k] for k in library}
    r["library_ms"] = min(r["library_calls"].values(), default=None)
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    lib = "".join(f"   {k} {v:.4f} ms" for k, v in r["library_calls"].items())
    print(f" kernel {name:<26s} {r['ms']:.4f} ms   plain "
          f"{r['plain_ms']:.4f} ms{lib}   bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {r['roofline_share']:.1%})")
    if library or queued:
        r["queued_ms"] = _time_queued(dict(kernel=kern, **library))
        print("   queued: " + "   ".join(
            f"{k} {v:.4f} ms" for k, v in r["queued_ms"].items()))
    return r


def _time_queued(fns: dict, calls=10) -> dict:
    """Median ms a call of each `fns[k]` with `calls` calls queued between
    two CUDA events (5 runs, in turns): the wrapper's host work overlaps
    the device's, so where a call's device work outlasts its host work
    this reads the device time, which one call between two events does
    not separate from the host's."""
    def queued(fn):
        def run():
            for _ in range(calls):
                fn()
        return run

    t = _time_turns({k: queued(f) for k, f in fns.items()},
                    dict.fromkeys(fns, 5))
    return {k: v / calls for k, v in t.items()}


def kernel_phase(dev) -> list:
    """Each segment kernel vs its plain version at main-path shapes,
    stacked over all 22 chromosomes (the count and the merge over both
    parents too) as one generation's launch gives them; as entries, the
    gather's one-table case (the dense path's) and the count and the merge
    at one chromosome."""
    import torch

    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.ops import cdf_bins as cb
    from geneevolve_tpu_torch.ops import materialize as mat
    from geneevolve_tpu_torch.ops import meiose_merge as mm
    from geneevolve_tpu_torch.ops import merge_count as mc
    from geneevolve_tpu_torch.ops import point_draws as pd

    BIG = segments.BIG
    g = torch.Generator(device=dev).manual_seed(1234)
    n = N_CHILD + 4 * int(N_CHILD ** 0.5) + 16  # plane rows at 30k
    nchr = SCENARIO["nchr"]
    # 50 kb bins, chr1's 4,981 down to ~960, padded as StackedMaps pads
    # them; uneven mass with flat runs
    KB, width, chr_len = 4981, 50_000, 249_000_000
    kc = torch.linspace(KB, 961, nchr, device=dev).long()
    mass = torch.rand((nchr, KB), generator=g, device=dev) * 1.3e-3
    mass[torch.rand((nchr, KB), generator=g, device=dev) < 0.2] = 0.0
    mass[:, 0] = 0.0
    mass[torch.arange(KB, device=dev)[None, :] >= kc[:, None]] = 0.0
    cum = torch.cumsum(mass, 1)
    bp = torch.arange(KB, device=dev, dtype=torch.int32) * width
    K, S, live, M, C = 23, 49, 16, 27, 100
    # the sampler's own u, as the main path produces it
    counts = torch.poisson(cum[:, -1:].expand(nchr, n).contiguous(),
                           generator=g).clamp_max(K).long()
    s = torch.cumsum(-torch.log1p(-torch.rand(
        (nchr, n, K + 1), generator=g, device=dev)), -1)
    u = (s[..., :K] / s.gather(-1, counts[..., None]).clamp_min(1e-30)
         * cum[:, -1, None, None])
    del s
    # parent ledgers of every chromosome: sorted valid prefix of ~16
    # boundaries, BIG padded
    lens = torch.randint(1, live * 2, (nchr, n, 2, 1), generator=g,
                         device=dev)
    pos = torch.randint(1, chr_len, (nchr, n, 2, S), generator=g, device=dev,
                        dtype=torch.int32)
    slot = torch.arange(S, device=dev)
    pos = torch.where(slot < lens, pos, BIG).sort(-1).values
    pos[..., 0] = 0
    seg_st = pos.contiguous()
    del pos
    seg_hap = torch.randint(0, 20_000, seg_st.shape, generator=g, device=dev,
                            dtype=torch.int16)
    seg_hap[seg_st >= BIG] = 0
    # each chromosome's crossovers from its own map and generator, for the
    # father's gametes and the mother's, as `_plan` draws them
    gens = [torch.Generator(device=dev).manual_seed(77 + c)
            for c in range(nchr)]
    drawn, draws = [], segments.point_draws
    segments.point_draws = lambda *a: drawn.append(a) or draws(*a)
    try:
        xo_f, xo_m = (segments.sample_point_process_stacked(
            gens, n, K, cum, cum[:, -1].tolist(),
            bp.expand(nchr, -1).contiguous(), [float(width)] * nchr, False)
            for _ in range(2))
    finally:
        segments.point_draws = draws
    d = drawn[0]  # the father's crossovers
    sh = torch.randint(0, 2, (nchr, n, 2), generator=g, device=dev,
                       dtype=torch.int32)
    parents = torch.randint(0, n, (2, n), generator=g, device=dev,
                            dtype=torch.int32)
    idx = parents[0]
    mut = torch.randint(0, chr_len, (nchr, n, 2, M), generator=g, device=dev,
                        dtype=torch.int32)
    cv = torch.randint(0, 2, (nchr, n, 2, C), generator=g, device=dev,
                       dtype=torch.uint8)
    count_args = (seg_st, parents, xo_f, xo_m, sh)
    merge_args = (seg_st, seg_hap, parents, xo_f, xo_m, sh)
    one = [x if x is parents else x[:1] for x in merge_args]  # chromosome 1

    cases = {
        "point_draws": (
            lambda: pd.point_draws(*d), lambda: pd.point_draws_plain(*d),
            _draws_work(*d), _draws_library(d), None),
        "cdf_bins": (
            lambda: cb.cdf_bins(u, cum), lambda: cb.cdf_bins_plain(u, cum),
            _bins_work(u, cum),
            {"searchsorted": lambda: torch.searchsorted(
                cum, u.view(nchr, -1), right=True, out_int32=True)},
            None),
        "merge_count": (
            lambda: mc.merge_count(*count_args),
            lambda: mc.merge_count_plain(*count_args),
            _count_work(*count_args), None,
            ("one_chromosome",
             lambda: mc.merge_count(one[0], *one[2:]),
             lambda: mc.merge_count_plain(one[0], *one[2:]),
             _count_work(one[0], *one[2:]), None)),
        "gather_rows": (
            lambda: mat.gather_rows_stacked(cv, idx),
            lambda: mat.gather_rows_stacked_plain(cv, idx),
            _gather_work(cv, idx, 1), _gather_library(cv, idx, 1),
            ("one_table",
             lambda: mat.gather_rows(cv[0], idx),
             lambda: mat.gather_rows_plain(cv[0], idx),
             _gather_work(cv[0], idx, 0), _gather_library(cv[0], idx, 0))),
        "meiose_merge": (
            lambda: mm.meiose_merge(*merge_args, S),
            lambda: mm.meiose_merge_plain(*merge_args, S, True),
            _merge_work(*merge_args, S), None,
            ("one_chromosome",
             lambda: mm.meiose_merge(*one, S),
             lambda: mm.meiose_merge_plain(*one, S, True),
             _merge_work(*one, S), None)),
    }
    # gamete inheritance at the in-place group shape (2 chromosomes of the
    # plane rows): ascending parent mutation rows with half their slots
    # live, ~1 de novo mutation in 10 slots, CV positions drawn anew
    from geneevolve_tpu_torch.ops import gamete_inherit as gi

    pm = torch.where(torch.rand((2, n, 2, M), generator=g, device=dev) < 0.5,
                     mut[:2], BIG).sort(-1).values
    new = torch.where(
        torch.rand((2, n, 11), generator=g, device=dev) < 0.1,
        torch.randint(0, chr_len, (2, n, 11), generator=g, device=dev,
                      dtype=torch.int32), BIG)
    q = torch.randint(0, chr_len, (2, C), generator=g, device=dev,
                      dtype=torch.int32)
    inherit = (pm, cv[:2], xo_f[:2], sh[:2, :, 0], new, q,
               torch.empty((2, n, M), dtype=torch.int32, device=dev),
               torch.empty((2, n, C), dtype=torch.uint8, device=dev))
    cases["gamete_inherit"] = (
        lambda: _inherit_outputs(gi.gamete_inherit)(*inherit),
        lambda: _inherit_outputs(gi.gamete_inherit_plain)(*inherit),
        _inherit_work(*inherit), None, None)
    results = []
    for name, (kern, plain, work, library, entry) in cases.items():
        r = dict(name=name, route="cuda", source=KERNELS[name][0],
                 replaces=KERNELS[name][1],
                 **_compare(name, kern, plain, work, library, reps_plain=20))
        if entry is not None:
            r["entries"] = [dict(entry=entry[0], **_compare(
                f"{name}/{entry[0]}", *entry[1:4], entry[4],
                reps_plain=20))]
        results.append(r)
    # the other merge mode and the mutation-row gathers: exactness only
    for got, want in (
        (mm.meiose_merge(*merge_args, S, False),
         mm.meiose_merge_plain(*merge_args, S, False)),
        (mat.gather_rows_stacked(mut, idx),
         mat.gather_rows_stacked_plain(mut, idx)),
        (mat.gather_rows(mut[0], idx), mat.gather_rows_plain(mut[0], idx)),
    ):
        if _max_abs_err(got, want) != 0:
            raise AssertionError("kernel differs from plain version")
    print(f"   (segment kernels at n={n} rows, {nchr} chromosomes stacked; "
          "median of 20 in turns)")
    return results


def _compare_packed(name: str, kern, plain, work: dict, wrapper) -> dict:
    """`_compare` for an entry of the packed or the byte meiosis, with the
    kernel also timed queued (at the dense slice's shape the wrapper's
    host time is a large part of one call) and the launch plan the entry
    used."""
    import dataclasses

    r = _compare(name, kern, plain, work, queued=True)
    r["plan"] = dataclasses.asdict(wrapper.plan)
    print("   plan: " + json.dumps(r["plan"]))
    return r


def _window_entries(hap, args, mu, cfg) -> list:
    """Kernel 4's window entry at the flagship's planes, as the sharded
    steps and the dense mesh launch it (in place, at a word offset, with
    the plan made local to the piece): four whole chromosomes, the second
    half of one and a chromosome less its first word (an odd word offset:
    heads and tails, 16-byte copies all the same); each against its plain
    version, timed and bounded as the whole-plane launch."""
    import torch

    from geneevolve_tpu_torch.ops import meiose_packed as mp
    from geneevolve_tpu_torch.parallel import mesh as pm

    L = cfg.chr_len
    pieces = {"window_whole_chromosomes": pm.Piece(4, 4, 0, L, 0),
              "window_half_chromosome": pm.Piece(3, 1, L // 2, L // 2, 0),
              "window_odd_word": pm.Piece(2, 1, 32, L - 32, 0)}
    f, mo, xo_p, st_p, xo_m, st_m = args
    outs = [torch.zeros_like(hap) for _ in range(2)]
    entries = []
    for name, pc in pieces.items():
        lo = pc.c0 * L + pc.off
        local = (f, mo, *pm.piece_plan(xo_p, st_p, pc, L),
                 *pm.piece_plan(xo_m, st_m, pc, L))
        mu_pc = pm.local_loci(mu, lo, pc.m)[0]
        kw = dict(n_chr=pc.n_chr, chr_len=pc.length)
        r = _compare_packed(
            f"meiose_packed/{name}",
            lambda: mp.meiose_packed_window(hap, outs[0], lo // 32, *local,
                                            mu_pc, **kw),
            lambda: mp.meiose_packed_window_plain(hap, outs[1], lo // 32,
                                                  *local, mu_pc, **kw),
            _packed_work(_packed_need(hap.shape[0], local, **kw), local,
                         mu_pc, **kw), mp.meiose_packed_window)
        entries.append(dict(entry=name, replaces=KERNELS["meiose_packed"][1],
                            words=pc.m // 32, word_offset=lo // 32, **r))
    return entries


def _planes_window_entries(hapA, hapB, args, rows: int, cfg) -> list:
    """Kernel 5's window entry on the byte planes, as the sharded byte
    step launches it: four whole chromosomes and a chromosome less its
    first 5 loci (an odd offset: heads and tails, 16-byte accesses all the
    same); each against its plain version, its bound the whole launch's
    scaled to the window's loci."""
    import torch

    from geneevolve_tpu_torch.ops import meiose_planes as mpl
    from geneevolve_tpu_torch.parallel import mesh as pm

    L = cfg.chr_len
    pieces = {"window_whole_chromosomes": pm.Piece(4, 4, 0, L, 0),
              "window_odd_offset": pm.Piece(2, 1, 5, L - 5, 0)}
    f, mo, xo_p, st_p, xo_m, st_m = args
    outs = [[torch.zeros((BYTE_N, cfg.m), dtype=torch.uint8,
                         device=hapA.device) for _ in range(2)]
            for _ in range(2)]
    entries = []
    for name, pc in pieces.items():
        lo = pc.c0 * L + pc.off
        local = (f, mo, *pm.piece_plan(xo_p, st_p, pc, L),
                 *pm.piece_plan(xo_m, st_m, pc, L))
        kw = dict(n_chr=pc.n_chr, chr_len=pc.length)
        r = _compare_packed(
            f"meiose_planes/{name}",
            lambda: mpl.meiose_planes_window(hapA, hapB, *outs[0], lo,
                                             *local, **kw),
            lambda: mpl.meiose_planes_window_plain(hapA, hapB, *outs[1], lo,
                                                   *local, **kw),
            _bound(rows * pc.m // cfg.m + _nbytes(*local)
                   + 2 * BYTE_N * pc.m, 2 * BYTE_N * pc.m),
            mpl.meiose_planes_window)
        entries.append(dict(entry=name, replaces=KERNELS["meiose_planes"][1],
                            loci=pc.m, offset=lo, **r))
    return entries


def _flagship_odd(dev, g, parents, plans) -> dict:
    """Kernel 4 at the flagship's odd twin: n 16,384, 8 chromosomes of
    131,040 loci (4,095 words: every child row a head or a tail), with
    mutations, against its plain version; bounded as the flagship."""
    import torch

    from geneevolve_tpu_torch.dense import packed
    from geneevolve_tpu_torch.ops import meiose_packed as mp

    cfg = packed.PackedConfig(**FLAGSHIP_ODD, couples=True)
    n, kw = cfg.n, dict(n_chr=cfg.n_chr, chr_len=cfg.chr_len)
    hap = torch.randint(-2**31, 2**31 - 1, (n, 2, cfg.mw), generator=g,
                        device=dev, dtype=torch.int32)
    args = (*parents(n, n), *plans(cfg.as_dense(), n))
    mu = torch.stack([packed.mutation_positions(g, n, cfg)[0]
                      for _ in range(2)], 1)
    r = _compare_packed(
        "meiose_packed/flagship_odd",
        lambda: mp.meiose_packed(hap, *args, mu, **kw),
        lambda: mp.meiose_packed_plain(hap, *args, mu, **kw),
        _packed_work(_packed_need(n, args, **kw), args, mu, **kw),
        mp.meiose_packed)
    return dict(entry="flagship_odd", replaces=KERNELS["meiose_packed"][1],
                shape=f"{n} x {cfg.n_chr} chromosomes of "
                f"{cfg.chr_len // 32} words", **r)


def _planes_m_odd(dev, g, parents, plans) -> dict:
    """Kernel 5 at n 4,096 x 8 chromosomes of 131,071 loci (m % 16 = 8:
    every other row 8 bytes off 16, so parent rows are shifted against
    their children's), against its plain version; bounded as the
    whole-plane entry."""
    import torch

    from geneevolve_tpu_torch.dense import step
    from geneevolve_tpu_torch.ops import meiose_planes as mpl

    dcfg = step.DenseConfig(n=BYTE_N, m=BYTE_ODD_M, n_chr=FLAGSHIP["n_chr"],
                            xo_cap=FLAGSHIP["xo_cap"])
    hapA, hapB = (torch.randint(0, 2, (BYTE_N, dcfg.m), generator=g,
                                device=dev, dtype=torch.uint8)
                  for _ in range(2))
    args = (*parents(BYTE_N, BYTE_N), *plans(dcfg, BYTE_N))
    rows = _rows_read(hapA, *args[:2]) + _rows_read(hapB, *args[:2])
    r = _compare_packed(
        "meiose_planes/m_odd",
        lambda: mpl.meiose_planes(hapA, hapB, *args, n_chr=dcfg.n_chr),
        lambda: mpl.meiose_planes_plain(hapA, hapB, *args,
                                        n_chr=dcfg.n_chr),
        _bound(rows + _nbytes(*args) + 2 * BYTE_N * dcfg.m,
               2 * BYTE_N * dcfg.m), mpl.meiose_planes)
    return dict(entry="m_odd", replaces=KERNELS["meiose_planes"][1],
                shape=f"{BYTE_N} x {dcfg.n_chr} chromosomes of "
                f"{dcfg.m // dcfg.n_chr} loci", **r)


def dense_kernel_phase(dev) -> list:
    """The packed meiosis (three entries) at the flagship shape and at its
    odd twin (`flagship_odd`: 8 chromosomes of 4,095 words), and the byte
    meiosis at n 4,096 x 1 Mi loci and at 8 chromosomes of 131,071 loci
    (`m_odd`), each against its plain version, with plans from the port's
    own sampler (couple-sorted parents, as the packed step draws them)."""
    import torch

    from geneevolve_tpu_torch.dense import packed, step
    from geneevolve_tpu_torch.ops import meiose_packed as mp
    from geneevolve_tpu_torch.ops import meiose_planes as mpl

    g = torch.Generator(device=dev).manual_seed(4321)
    cfg = packed.PackedConfig(**FLAGSHIP, couples=True)
    n, kw = cfg.n, dict(n_chr=cfg.n_chr, chr_len=cfg.chr_len)

    def parents(n_par, n):
        cc = torch.randint(0, n // 2, (n,), generator=g, device=dev).sort()
        return [torch.randint(0, n_par, (n,), generator=g, device=dev,
                              dtype=torch.int32)[cc.values]
                for _ in range(2)]

    def plans(dcfg, n):
        xo_p, st_p, _ = step._sample_gamete_plan(g, dcfg, n)
        xo_m, st_m, _ = step._sample_gamete_plan(g, dcfg, n)
        return xo_p, st_p, xo_m, st_m

    hap = torch.randint(-2**31, 2**31 - 1, (n, 2, cfg.mw), generator=g,
                        device=dev, dtype=torch.int32)
    args = (*parents(n, n), *plans(cfg.as_dense(), n))
    mu = torch.stack([packed.mutation_positions(g, n, cfg)[0]
                      for _ in range(2)], 1)
    results = []

    need = _packed_need(n, args, cfg.n_chr, cfg.chr_len)

    def work(m):
        return _packed_work(need, args, m, cfg.n_chr, cfg.chr_len)

    main = _compare_packed("meiose_packed",
                           lambda: mp.meiose_packed(hap, *args, mu, **kw),
                           lambda: mp.meiose_packed_plain(hap, *args, mu,
                                                          **kw),
                           work(mu), mp.meiose_packed)
    entries = [dict(entry="no_mutations", replaces=PACKED_ENTRIES[
        "no_mutations"], **_compare_packed(
            "meiose_packed/no_mutations",
            lambda: mp.meiose_packed(hap, *args, None, **kw),
            lambda: mp.meiose_packed_plain(hap, *args, None, **kw),
            work(None), mp.meiose_packed))]
    entries += _window_entries(hap, args, mu, cfg)
    hapA, hapB = hap[:, 0].contiguous(), hap[:, 1].contiguous()
    del hap
    entries.append(dict(entry="split_planes", replaces=PACKED_ENTRIES[
        "split_planes"], **_compare_packed(
            "meiose_packed/split_planes",
            lambda: mp.meiose_packed_split(hapA, hapB, *args, **kw),
            lambda: mp.meiose_packed_split_plain(hapA, hapB, *args, **kw),
            work(None), mp.meiose_packed_split)))
    del hapA, hapB
    torch.cuda.empty_cache()
    entries.append(_flagship_odd(dev, g, parents, plans))
    results.append(dict(name="meiose_packed", entries=entries, **main))
    torch.cuda.empty_cache()

    dcfg = step.DenseConfig(n=BYTE_N, m=cfg.m, n_chr=cfg.n_chr,
                            xo_cap=cfg.xo_cap)
    hapA = torch.randint(0, 2, (BYTE_N, cfg.m), generator=g, device=dev,
                         dtype=torch.uint8)
    hapB = torch.randint(0, 2, (BYTE_N, cfg.m), generator=g, device=dev,
                         dtype=torch.uint8)
    args = (*parents(BYTE_N, BYTE_N), *plans(dcfg, BYTE_N))
    rows = _rows_read(hapA, *args[:2]) + _rows_read(hapB, *args[:2])
    results.append(dict(name="meiose_planes", **_compare(
        "meiose_planes",
        lambda: mpl.meiose_planes(hapA, hapB, *args, n_chr=cfg.n_chr),
        lambda: mpl.meiose_planes_plain(hapA, hapB, *args,
                                        n_chr=cfg.n_chr),
        _bound(rows + _nbytes(*args) + 2 * BYTE_N * cfg.m,
               2 * BYTE_N * cfg.m))))
    results[-1]["entries"] = _planes_window_entries(hapA, hapB, args, rows,
                                                    cfg)
    del hapA, hapB
    torch.cuda.empty_cache()
    results[-1]["entries"].append(_planes_m_odd(dev, g, parents, plans))
    torch.cuda.empty_cache()
    for r in results:
        r.update(route="cuda", source=KERNELS[r["name"]][0],
                 replaces=KERNELS[r["name"]][1])
    return results


def _mutation_map(path: Path, rmap: Path, rate=None) -> Path:
    """`chr bp rate` on the recombination map's bins: per-bin rate 1/K so a
    gamete carries ~1 de novo mutation per chromosome on the segment law,
    or `rate` in every bin (1 is the map's limit: the reader zeroes rates
    above it)."""
    rows = [line.split() for line in rmap.read_text().splitlines()[1:]]
    per_chr = {}
    for c, bp, _cm in rows:
        per_chr.setdefault(c, []).append(bp)
    with open(path, "w") as f:
        f.write("chr bp rate\n")
        for c, bps in per_chr.items():
            r = 1.0 / len(bps) if rate is None else rate
            f.writelines(f"{c} {bp} {r:.8g}\n" for bp in bps)
    return path


def _cvs_on_panel(root: Path, seed: int) -> None:
    """Move every CV onto a panel site, as when CVs are taken from the
    reference panel: `cv.info` keeps each chromosome's effects at sites
    drawn from its legend, and each CV hap row becomes the panel's row at
    that site. The founders' resident CVs then equal their planes at the
    CV columns, and every later generation's must too."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head, *rows = (root / "cv.info").read_text().splitlines()
    by_chr = {}
    for r in rows:
        by_chr.setdefault(r.split()[0], []).append(r.split())
    out = [head]
    for c, rs in by_chr.items():
        legend = (root / f"ref.chr{c}.legend").read_text().splitlines()[1:]
        idx = np.sort(rng.choice(len(legend), len(rs), replace=False))
        panel = (root / f"ref.chr{c}.hap").read_bytes().splitlines(True)
        (root / f"cv.chr{c}.hap").write_bytes(b"".join(panel[i] for i in idx))
        out += [" ".join([c, legend[i].split()[1], *r[2:]])
                for i, r in zip(idx, rs)]
    (root / "cv.info").write_text("\n".join(out) + "\n")


def _scenario(root: Path, cvs_on_panel=False, **kw) -> list:
    sys.path.insert(0, str(REPO / "tools"))
    from mkscenario import make_scenario

    flags = make_scenario(str(root), **kw)
    if cvs_on_panel:
        _cvs_on_panel(root, kw.get("seed", 1))
    flags["file_mutation_map"] = str(
        _mutation_map(root / "mut.txt", Path(flags["file_recom_map"]))
    )
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    return argv


def parity_phase(dev, work: Path) -> int:
    """Slice on `dev` vs on the CPU, the device run fed the CPU run's
    plans: identical planes every generation. Returns generations checked."""
    import torch

    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.core.engine import Simulation

    argv = _scenario(work / "parity", n0=200, pop_size=300, gens=3, nchr=3,
                     ncv=12, seed=3)
    sims = {}
    for name, d in (("cpu", "cpu"), ("dev", dev)):
        cfg = parse_args(argv + ["--seed", "7", "--prefix",
                                 str(work / "parity" / name)])
        sims[name] = Simulation(cfg, device=d, verbose=False)
    ref, sim = sims["cpu"], sims["dev"]
    mates, plans = {}, {}
    ref_mate, ref_plan = ref._mate, ref._plan
    ref._mate = lambda p, gen, ps, g: mates.setdefault(
        gen, ref_mate(p, gen, ps, g))
    ref._plan = lambda p, gen, n_pad: plans.setdefault(
        gen, ref_plan(p, gen, n_pad))
    sim._mate = lambda p, gen, ps, g: mates[gen]
    sim._plan = lambda p, gen, n_pad: tuple(x.to(dev) for x in plans[gen])
    for s in (ref, sim):
        s.init_generation0()
    for gen in range(ref.tot_gen + 1):
        if gen:
            ref.step(gen)
            sim.step(gen)
        a, b = ref.pops[0].state, sim.pops[0].state
        for k in ("seg_st", "seg_hap", "mut", "cv"):
            if not torch.equal(getattr(a, k), getattr(b, k).cpu()):
                raise AssertionError(f"parity: {k} differs at gen {gen}")
    if not (ref.pops[0].state.mut < 2**30).any():
        raise AssertionError("parity: no mutation was inherited")
    for s in (ref, sim):
        s.write_summary()
        s._io_pool.shutdown(wait=True)
    print(f" parity: cuda == cpu for gens 0..{ref.tot_gen} (ledger, "
          "mutations, resident CVs)")
    return ref.tot_gen + 1


def _read_table(path: Path):
    import numpy as np

    lines = path.read_text().splitlines()
    return lines[0].split(), np.array([l.split() for l in lines[1:]],
                                      dtype=np.float64)


def _with(argv: list, flag: str, value: str) -> list:
    """`argv` with `flag`'s value replaced."""
    argv = list(argv)
    argv[argv.index(flag) + 1] = value
    return argv


def _popinfo(root: Path, scenario: dict, gens: int, mat_cor=0.0) -> Path:
    """A generation-info file of `gens` rows of the scenario's schedule."""
    path = root / f"popinfo{gens}.txt"
    path.write_text(
        "pop_size mat_cor offspring_dist selection_func selection_func_par1 "
        "selection_func_par2\n"
        + f"{scenario['pop_size']} {mat_cor:g} p thr 1 1\n" * gens)
    return path


def slice_phase(dev, work: Path, name: str, scenario: dict,
                extra=(), base=None, before_step=None) -> dict:
    """A Table 3.1-shaped scenario through the CLI, with its checks. `base`:
    the scenario argv of an earlier phase to run again (else the scenario
    is written under `work / name`); outputs go to `work / name / out.*`.
    `before_step(sim, gen)` runs before each generation, outside its
    timing. Besides s/gen and the run's peak device memory, each
    generation's peak and the peaks of its parts (`_peaks`), and the
    memory reckoning's need (`core/memory.reckon`, `mem_plan`)."""
    import numpy as np
    import torch

    from geneevolve_tpu_torch import cli
    from geneevolve_tpu_torch.core import engine

    root = work / name
    root.mkdir(parents=True, exist_ok=True)
    base = base or _scenario(root, **scenario, seed=1)
    argv = base + ["--seed", "12345", "--prefix", str(root / "out"),
                   "--stage_sync", *extra]
    seen, gen_s, gen0, parts = [], [], {}, []
    run, step = engine.Simulation.run, engine.Simulation.step
    init = engine.Simulation.init_generation0
    peak = [0]

    def run_rec(self):
        seen.append(self)
        return run(self)

    def init_rec(self):
        init(self)
        gen0.update({k: w.launches for k, w in _wrappers().items()})

    def step_rec(self, gen):
        if before_step is not None:
            before_step(self, gen)
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _peaks(parts):
            step(self, gen)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
        peak[0] = max(peak[0], parts[-1]["gen"])

    engine.Simulation.run, engine.Simulation.step = run_rec, step_rec
    engine.Simulation.init_generation0 = init_rec
    try:
        gc.collect()  # no cyclic garbage of an earlier phase in the peaks
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(argv, device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.Simulation.run, engine.Simulation.step = run, step
        engine.Simulation.init_generation0 = init
    if rc != 0:
        raise AssertionError(f"{name}: cli.main returned {rc}")
    sim = seen[0]
    # outputs: sizes and law
    G, pop = sim.tot_gen, scenario["pop_size"]
    for gen in range(G + 1):
        _, info = _read_table(root / f"out.info.pop1.gen{gen}.txt")
        if gen == 0 and info.shape[0] != scenario["n0"]:
            raise AssertionError(f"{name}: gen 0 has {info.shape[0]} "
                                 "founders")
        if gen and abs(info.shape[0] - pop) > 6 * pop ** 0.5:
            raise AssertionError(f"{name}: gen {gen} size {info.shape[0]}")
        if not np.isfinite(info).all():
            raise AssertionError(f"{name}: non-finite values in gen {gen}")
    hdr, summ = _read_table(root / "out.pop1.summary")
    var_a, h2 = summ[:, hdr.index("ph1_var_A")], summ[:, hdr.index("ph1_h2")]
    if summ.shape[0] != G + 1 or not np.isfinite(var_a).all() \
            or not ((h2 > 0) & (h2 <= 1)).all():
        raise AssertionError(f"{name}: summary var_A {var_a}, h2 {h2}")
    split = {k: round(v, 4) for k, v in sim.timer.totals.items()}
    mib = 2**20
    plan = getattr(sim, "mem_plan", None)  # the segment engine's
    out = dict(
        wall_s=wall, s_per_gen=gen_s, stage_split_s=split,
        max_memory_allocated_mb=max(
            peak[0], torch.cuda.max_memory_allocated()) / mib,
        peaks_per_gen_mb=[{k: v / mib for k, v in x.items()}
                          for x in parts],
        sim=sim, argv=base, root=root, gen0_launches=gen0,
        reckoned=None if plan is None else dict(
            need_mb=plan.need / mib, resident_cv=plan.resident_cv,
            in_place=plan.in_place, per_group=plan.per_group,
            gather_chunk=plan.gather_chunk),
    )
    print(f" {name}: s/gen " + " ".join(f"{x:.3f}" for x in gen_s))
    print(f" {name}: stage split (s, all gens) {json.dumps(split)}")
    print(f" {name}: max_memory_allocated "
          f"{out['max_memory_allocated_mb']:.1f} MiB, wall {wall:.1f} s; "
          "a generation's peak (probe / real pass / the rest) "
          + ", ".join(f"{x['probe']:.0f}/{x['real']:.0f}/{x['rest']:.0f}"
                      for x in out["peaks_per_gen_mb"]) + " MiB")
    if plan is not None:
        print(f" {name}: reckoned need {plan.need / mib:.1f} MiB "
              f"(resident {plan.resident_cv}, in place {plan.in_place}, "
              f"per-group plan {plan.per_group}, gathers of "
              f"{plan.gather_chunk} chromosomes) beside the measured "
              f"{out['max_memory_allocated_mb']:.1f} MiB")
    return out


@contextlib.contextmanager
def _peaks(parts: list):
    """Within it (one generation), the peak device memory of the part
    before the real pass (mating, the probe), of the real pass and of the
    rest (A/D, phenotypes, migration), appended to `parts` as a dict in
    bytes with the generation's (`gen`); allocator statistics, no sync."""
    import torch

    from geneevolve_tpu_torch.core import engine

    got = {"probe": 0, "real": 0}
    saved = {k: getattr(engine.Simulation, k)
             for k in ("_real_pass", "_real_pass_in_place")}

    def wrap(fn):
        def rec(*a, **k):
            got["probe"] = max(got["probe"], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            r = fn(*a, **k)
            got["real"] = max(got["real"], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return r
        return rec

    for k, fn in saved.items():
        setattr(engine.Simulation, k, wrap(fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(engine.Simulation, k, fn)
    torch.cuda.synchronize()
    rest = torch.cuda.max_memory_allocated()
    parts.append(dict(got, rest=rest, gen=max(got["probe"], got["real"],
                                              rest)))


def _checksum(u):
    """An exact checksum of a float tensor's bits, left on the card."""
    import torch

    return u.view(torch.int32).sum(dtype=torch.int64)


# ----------------------------------------- launches that read the parents
PLANES = ("seg_st", "seg_hap", "mut", "cv")
# the kernels that read the parents' planes, which a real pass in place
# overwrites with the children
PARENT_KERNELS = ("merge_count", "meiose_merge", "gather_rows",
                  "gamete_inherit")
# (chromosome, child) pairs a call of a plain version takes in a re-check
PLAIN_PAIRS = 1 << 20


def _parents_copy(sim) -> dict:
    """Every population's genome planes copied to the host: (population,
    plane) -> (the plane's card address, the copy)."""
    out = {}
    for p in sim.pops:
        for k in PLANES:
            t = getattr(p.state, k)
            if t is None or t.numel() == 0:
                continue
            if not t.is_contiguous():
                raise AssertionError(f"pop {p.index + 1}: {k} is not "
                                     "contiguous")
            out[p.index, k] = (t.data_ptr(), t.to("cpu", copy=True))
    return out


def _desc(t) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


def _inherit_outputs(fn):
    """`fn` (`ops/gamete_inherit` or its plain version) with the arguments
    of a call, writing into fresh child planes laid out as the engine's (a
    parent's [:, :, g] view of (nk, nc, 2, width) planes) in place of the
    call's own outputs: returns what it wrote, (mutation rows, counts, CV
    rows), those the call has."""
    import torch

    def plane(t):
        return None if t is None else torch.empty(
            t.shape[:2] + (2,) + t.shape[2:], dtype=t.dtype,
            device=t.device)[:, :, 1]

    def run(pm, cv, xo, start, new, q, out_mut, out_cv):
        om, oc = plane(out_mut), plane(out_cv)
        counts = fn(pm, cv, xo, start, new, q, om, oc)
        return tuple(x for x in (om, counts, oc) if x is not None)

    return run


def _int_sum(t):
    """A checksum of an integer tensor, left on the card (None for None)."""
    import torch

    return None if t is None else t.sum(dtype=torch.int64)


def _inherit_operands(path, sim, plan_of, gathered, sums, widths):
    """A recorded gamete inheritance's operands, made again: its parent
    rows, the last gathers of the mutation and CV planes (`gathered`:
    plane -> ((population, c0, c1, parents), rows)), held to the launch's
    checksums; its crossovers, starts and de novo slots, those of the
    parent of the range's plan drawn again whose checksums they match; its
    chromosomes' CV positions; fresh outputs of the recorded widths.
    Returns (population, c0, c1, parent, arguments)."""
    import torch

    pm_s, cv_s, xo_s, st_s, new_s = sums
    rows, at = {}, None
    for plane, want in (("mut", pm_s), ("cv", cv_s)):
        rows[plane] = None
        if want is None:
            continue
        if plane not in gathered or (
                at is not None and (gathered[plane][0][:3] != at[:3]
                                    or gathered[plane][0][3] is not at[3])):
            raise AssertionError(f"{path}: a gamete inheritance without "
                                 f"the gather of its {plane} rows before it")
        at, rows[plane] = gathered[plane]
        if int(_int_sum(rows[plane])) != int(want):
            raise AssertionError(f"{path}: the {plane} rows gathered again "
                                 "differ from the gamete inheritance's")
    pop, c0, c1, _ = at
    plan = plan_of(pop, c0, c1)
    want = [int(x) for x in (xo_s, st_s, new_s)]
    g = next((g for g in range(2) if [int(_int_sum(x)) for x in (
        plan[g], plan[2][:, :, g], plan[3 + g])] == want), None)
    if g is None:
        raise AssertionError(f"{path}: no parent's plan rows match the "
                             f"gamete inheritance's (pop {pop + 1}, "
                             f"chromosomes {c0}-{c1 - 1})")
    nk, nc = plan[g].shape[:2]
    dev = plan[g].device
    Mo, C = widths
    args = (rows["mut"], rows["cv"], plan[g], plan[2][:, :, g], plan[3 + g],
            sim.cv_bp_all[c0:c1],
            None if Mo is None else torch.empty((nk, nc, Mo),
                                                dtype=torch.int32,
                                                device=dev),
            None if C is None else torch.empty((nk, nc, C),
                                               dtype=torch.uint8, device=dev))
    return pop, c0, c1, g, args


class _ParentLaunches:
    """Records the launches of a run's last generation (`last_gen`) that
    read the parents' planes, so that each can be made again after the run
    on its real inputs (`_recheck`), though a real pass in place writes the
    children over them. `before_step` (`slice_phase`'s hook, outside the
    timing) copies every parent plane to the host before that generation;
    within the context the hooks keep, with no copy and no reference to a
    plane or a plan, each launch's plane addresses and shapes, the
    children's parents (which the generation holds anyway) and an exact
    checksum of its crossovers and starts (a reduction on the card, no
    sync), and each population's `_plan` arguments; of a gamete
    inheritance, checksums of its operands (its parent rows are the
    gathers just before it) and its outputs' widths."""

    def __init__(self, last_gen: int):
        self.last, self.on = last_gen, False
        self.sim = self.copy = None
        self.launches, self.plans = [], {}

    def before_step(self, sim, gen):
        self.on = gen == self.last
        if self.on:
            self.sim, self.copy = sim, _parents_copy(sim)

    def __enter__(self):
        from geneevolve_tpu_torch.core import engine

        self.saved = {k: getattr(engine, k) for k in (
            "merge_count", "meiose_merge", "gather_rows_stacked",
            "gamete_inherit")}
        self.saved_plan = engine.Simulation._plan
        count, merge = engine.merge_count, engine.meiose_merge
        inherit = engine.gamete_inherit
        gather, plan = engine.gather_rows_stacked, engine.Simulation._plan

        def sums(*ts):
            return [_checksum(t) for t in ts]

        def count_rec(seg_st, parents, xo_f, xo_m, sh):
            if self.on:
                self.launches.append(("merge_count", [_desc(seg_st)],
                                      parents, sums(xo_f, xo_m, sh), ()))
            return count(seg_st, parents, xo_f, xo_m, sh)

        def merge_rec(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap,
                      merge_ibd):
            if self.on:
                self.launches.append((
                    "meiose_merge", [_desc(seg_st), _desc(seg_hap)], parents,
                    sums(xo_f, xo_m, sh), (cap, merge_ibd)))
            return merge(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap,
                         merge_ibd)

        def gather_rec(table, idx):
            if self.on:
                self.launches.append(("gather_rows", [_desc(table)], idx,
                                      None, ()))
            return gather(table, idx)

        def inherit_rec(pm, cv, xo, start, new, q, out_mut, out_cv):
            if self.on:
                self.launches.append((
                    "gamete_inherit", None, None,
                    [_int_sum(t) for t in (pm, cv, xo, start, new)],
                    tuple(None if t is None else t.shape[-1]
                          for t in (out_mut, out_cv))))
            return inherit(pm, cv, xo, start, new, q, out_mut, out_cv)

        def plan_rec(sim, p, gen, n_pad, c0=0, c1=None):
            if self.on:
                self.plans[p.index] = (p, gen, n_pad)
            return plan(sim, p, gen, n_pad, c0, c1)

        engine.merge_count, engine.meiose_merge = count_rec, merge_rec
        engine.gather_rows_stacked = gather_rec
        engine.gamete_inherit = inherit_rec
        engine.Simulation._plan = plan_rec
        return self

    def __exit__(self, *exc):
        from geneevolve_tpu_torch.core import engine

        for k, fn in self.saved.items():
            setattr(engine, k, fn)
        engine.Simulation._plan = self.saved_plan
        # the hooks it wrapped may hold their caller's state: no cycle
        self.on, self.saved, self.saved_plan = False, None, None


def _plain_chunked(plain, args, axes):
    """`plain(*args)` over chunks of at most `PLAIN_PAIRS` (chromosome,
    child) pairs, put together: the tensors of one call (an output's
    chromosome and child rows depend only on their own inputs) in bounded
    memory. `axes[i]`: argument i's chromosome and child axes, None where
    it has none; every output has them at 0 and 1."""
    import torch

    nchr = next(a.shape[c] for a, (c, _) in zip(args, axes) if c is not None)
    nc = next(a.shape[r] for a, (_, r) in zip(args, axes) if r is not None)
    cc = max(1, min(nchr, PLAIN_PAIRS // nc))
    rc = min(nc, max(1, PLAIN_PAIRS // cc))
    if cc == nchr and rc == nc:
        return plain(*args)

    def part(c0, r0):
        sub = []
        for a, (ca, ra) in zip(args, axes):
            if ca is not None:
                a = a.narrow(ca, c0, min(cc, nchr - c0))
            if ra is not None:
                a = a.narrow(ra, r0, min(rc, nc - r0))
            sub.append(a.contiguous() if (ca, ra) != (None, None) else a)
        out = plain(*sub)
        return out if isinstance(out, tuple) else (out,)

    outs = []
    for c0 in range(0, nchr, cc):
        parts = [part(c0, r0) for r0 in range(0, nc, rc)]
        outs.append(tuple(torch.cat(x, 1) for x in zip(*parts)))
    out = tuple(torch.cat(x, 0) for x in zip(*outs))
    return out if len(out) > 1 else out[0]


GATHER_AXES = ((0, None), (None, 0))
COUNT_AXES = ((0, None), (None, 1), (0, 1), (0, 1), (0, 1))
MERGE_AXES = ((0, None), (0, None), (None, 1), (0, 1), (0, 1), (0, 1),
              (None, None), (None, None))
INHERIT_AXES = ((0, 1), (0, 1), (0, 1), (0, 1), (0, 1), (0, None), (0, 1),
                (0, 1))


def _recheck(path: str, rec: _ParentLaunches, children=False) -> dict:
    """Every launch `rec` recorded, made again (comparison launches, after
    the counted run) on its real inputs at its full shape: the parents'
    planes from the host copy, back on the card; the crossovers and starts
    drawn again by the generation's `_plan` (a fresh generator a
    chromosome: a chromosome range's rows of the whole plan), held to the
    launch's checksums. Each equals its plain version (`_plain_chunked`)
    bit for bit. `children`: the run had one population and no migration,
    so each merge must also equal the children the run wrote (its final
    planes), every row. Returns `checked` (launches a kernel), `planes`
    (the copy on the card) and `last` (the last launch of each kernel, of
    the gathers the last 4, as [(kernel, plain version in chunks,
    arguments, (population, c0, c1))]). A gamete inheritance runs on its
    operands made again (`_inherit_operands`) and, with `children`, must
    equal the mutation and CV rows the run wrote."""
    import torch

    from geneevolve_tpu_torch.ops import gamete_inherit as gi
    from geneevolve_tpu_torch.ops import materialize as mat
    from geneevolve_tpu_torch.ops import meiose_merge as mm
    from geneevolve_tpu_torch.ops import merge_count as mc

    sim = rec.sim
    if sim is None or not rec.launches:
        raise AssertionError(f"{path}: no launch of the last generation "
                             "recorded")
    planes = {key: (ptr, host.to(sim.device))
              for key, (ptr, host) in rec.copy.items()}
    final = sim.pops[0].state if children else None

    def locate(desc):
        ptr, shape, dtype = desc
        for (pop, k), (start, c) in planes.items():
            off = ptr - start
            if not 0 <= off < c.numel() * c.element_size():
                continue
            per_chr = c[0].numel() * c.element_size()
            c0 = off // per_chr
            if off % per_chr or c.dtype != dtype or tuple(
                    c.shape[1:]) != shape[1:] or c0 + shape[0] > c.shape[0]:
                raise AssertionError(f"{path}: a launch reads {k} of pop "
                                     f"{pop + 1} in a way the copy misses")
            return pop, c0, c[c0:c0 + shape[0]], k
        raise AssertionError(f"{path}: a launch reads a plane that was not "
                             "a parent plane before the last generation")

    drawn = {}

    def plan_of(pop, c0, c1):
        if (pop, c0, c1) not in drawn:
            drawn.clear()  # one range's plan at a time
            p, gen, n_pad = rec.plans[pop]
            drawn[pop, c0, c1] = sim._plan(p, gen, n_pad, c0, c1)
        return drawn[pop, c0, c1]

    checked = dict.fromkeys(PARENT_KERNELS, 0)
    last = {k: [] for k in PARENT_KERNELS}
    gathered = {}  # plane -> ((pop, c0, c1, parents), rows) of its last
    for kind, descs, parents, sums, extra in rec.launches:
        if kind == "gamete_inherit":
            pop, c0, c1, g, args = _inherit_operands(
                path, sim, plan_of, gathered, sums, extra)
            kern, plain = (_inherit_outputs(gi.gamete_inherit),
                           _inherit_outputs(gi.gamete_inherit_plain))
            axes = tuple((None, None) if a is None else x
                         for a, x in zip(args, INHERIT_AXES))
            got = kern(*args)
            err = _max_abs_err(got, _plain_chunked(plain, args, axes))
            if err:
                raise AssertionError(f"{path}: gamete_inherit (pop "
                                     f"{pop + 1}, chromosomes {c0}-{c1 - 1})"
                                     f" differs from its plain version by "
                                     f"{err}")
            if final is not None and not (
                    (args[0] is None
                     or torch.equal(got[0], final.mut[c0:c1, :, g]))
                    and (args[1] is None
                         or torch.equal(got[-1], final.cv[c0:c1, :, g]))):
                raise AssertionError(
                    f"{path}: the mutation or CV rows the run wrote differ "
                    f"from the gamete inheritance (chromosomes "
                    f"{c0}-{c1 - 1}, parent {g})")
            del got
            checked[kind] += 1
            last[kind] = [(kern, lambda a=args, f=plain, x=axes:
                           _plain_chunked(f, a, x), args, (pop, c0, c1))]
            continue
        pop, c0, view, plane = locate(descs[0])
        c1 = c0 + view.shape[0]
        if kind == "gather_rows":
            kern, plain, axes = (mat.gather_rows_stacked,
                                 mat.gather_rows_stacked_plain, GATHER_AXES)
            args = (view, parents)
        else:
            xo_f, xo_m, sh = plan_of(pop, c0, c1)[:3]
            if [int(_checksum(x)) for x in (xo_f, xo_m, sh)] != [
                    int(s) for s in sums]:
                raise AssertionError(
                    f"{path}: the crossovers and starts drawn again differ "
                    f"from the {kind} launch's (pop {pop + 1}, chromosomes "
                    f"{c0}-{c1 - 1})")
            if kind == "merge_count":
                kern, plain, axes = (mc.merge_count, mc.merge_count_plain,
                                     COUNT_AXES)
                args = (view, parents, xo_f, xo_m, sh)
            else:
                kern, plain, axes = (mm.meiose_merge, mm.meiose_merge_plain,
                                     MERGE_AXES)
                args = (view, locate(descs[1])[2], parents, xo_f, xo_m, sh,
                        *extra)
        got = kern(*args)
        if kind == "gather_rows":
            gathered[plane] = ((pop, c0, c1, parents), got)
        err = _max_abs_err(got, _plain_chunked(plain, args, axes))
        if err:
            raise AssertionError(f"{path}: {kind} (pop {pop + 1}, "
                                 f"chromosomes {c0}-{c1 - 1}) differs from "
                                 f"its plain version by {err}")
        if kind == "meiose_merge" and final is not None and not (
                torch.equal(got[0], final.seg_st[c0:c1])
                and torch.equal(got[1], final.seg_hap[c0:c1])):
            raise AssertionError(f"{path}: the children the run wrote "
                                 f"differ from the merge (chromosomes "
                                 f"{c0}-{c1 - 1})")
        del got
        checked[kind] += 1
        keep = 4 if kind == "gather_rows" else 1
        last[kind] = (last[kind] + [(
            kern, lambda a=args, f=plain, x=axes: _plain_chunked(f, a, x),
            args, (pop, c0, c1))])[-keep:]
    print(f" {path}: {json.dumps(checked)} launches of the last generation "
          "== plain on their own inputs"
          + ("; every merge == the children the run wrote" if children
             else ""))
    return dict(checked=checked, planes=planes, last=last)


def segment_slice(dev, work: Path) -> dict:
    """The segment engine's slice, and its probe/real-pass tripwire. Kept
    under `captured` for `segment_slice_kernels`: the launches of the last
    generation that read the parents (`_ParentLaunches`: a host copy of
    the parents' planes taken before that generation, outside its timing,
    since its real pass writes the children over them), and its plan's
    arguments with a checksum of each of its stacked draws of uniforms (one
    reduction on the card each, no copy and no host sync inside the timed
    run), so that the plan is drawn again after the run."""
    from geneevolve_tpu_torch.core import engine, segments

    captured = {"point_draws": [], "plan": None}
    draws, plan = segments.point_draws, engine.Simulation._plan
    last = SEGMENT_PER_GEN["point_draws"] * (SCENARIO["gens"] - 1)
    seen = [0]

    def plan_rec(self, p, gen, n_pad, c0=0, c1=None):
        captured["plan"] = (self, p, gen, n_pad)
        return plan(self, p, gen, n_pad, c0, c1)

    def draws_rec(*a):
        seen[0] += 1
        if seen[0] > last:  # the last generation's launches
            captured["point_draws"].append(_checksum(a[1]))
        return draws(*a)

    segments.point_draws, engine.Simulation._plan = draws_rec, plan_rec
    try:
        with _ParentLaunches(SCENARIO["gens"]) as rec:
            out = slice_phase(dev, work, "table31", SCENARIO,
                              before_step=rec.before_step)
    finally:
        segments.point_draws, engine.Simulation._plan = draws, plan
    captured["parents"] = rec
    out["captured"] = captured
    sim = out.pop("sim")
    st, log = sim.pops[0].state, sim.capacity_log
    if sim.mem_plan is None or not sim.mem_plan.in_place:
        raise AssertionError("table31: not in place")
    # the final ledgers and mutations: the full-width paint check
    out["final"] = (st.seg_st, st.seg_hap, st.mut, st.n,
                    [sim.pops[0].rmaps[c].chr_end for c in sim.chrs])
    if len(log) != SCENARIO["gens"] or any(
            c["seg_need"] != c["seg_used"] for c in log):
        raise AssertionError(f"capacity tripwire: {log}")
    if sum(c["mut_used"] for c in log) == 0:
        raise AssertionError("no de novo mutation was carried")
    out["seg_need_used"] = [(c["seg_need"], c["seg_used"]) for c in log]
    return out


def segment_slice_kernels(kernels: list, captured: dict) -> dict:
    """The stacked kernels against their plain versions on the segment
    slice's last generation's own inputs, bit-exact: every launch that
    read the parents (`_recheck`: the count, the 11 merges, each equal to
    the children the run wrote over the parents, and the 44 gathers), and
    its 3 draws launches; timed into the kernels' `entries`: the draws,
    the last group's 4 gathers, the count, the merge of the last group and,
    at the stacked shape of the probe, over every chromosome (both modes).
    The plan is drawn again by the last generation's `_plan` (a fresh
    generator per chromosome, seeded from the generation): its draws must
    match the run's checksums."""
    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.ops import meiose_merge as mm
    from geneevolve_tpu_torch.ops import point_draws as pd

    by_name = {k["name"]: k for k in kernels}
    names = ("crossovers_father", "crossovers_mother", "mutations")
    if len(captured["point_draws"]) != len(names):
        raise AssertionError("segment slice: last generation's draws "
                             f"launches {len(captured['point_draws'])}")
    res = _recheck("table31", captured["parents"], children=True)
    want = dict(merge_count=1, meiose_merge=GROUPS,
                gather_rows=SEGMENT_PER_GEN["gather_rows"],
                gamete_inherit=SEGMENT_PER_GEN["gamete_inherit"])
    if res["checked"] != want:
        raise AssertionError(f"table31: last generation's launches "
                             f"{res['checked']}, {want} expected")
    sim, p, gen, n_pad = captured["plan"]
    drawn, draws = [], segments.point_draws
    segments.point_draws = lambda *a: drawn.append(a) or draws(*a)
    try:
        xo_f, xo_m, sh = sim._plan(p, gen, n_pad)[:3]
    finally:
        segments.point_draws = draws
    del sim
    if [int(_checksum(a[1])) for a in drawn] != [
            int(c) for c in captured["point_draws"]]:
        raise AssertionError("segment slice: the last generation's draws, "
                             "drawn again, differ from the run's")
    for a, what in zip(drawn, names):
        r = _compare(f"point_draws/segment_slice/{what}",
                     lambda: pd.point_draws(*a),
                     lambda: pd.point_draws_plain(*a), _draws_work(*a),
                     _draws_library(a))
        by_name["point_draws"].setdefault("entries", []).append(
            dict(entry=f"segment_slice/{what}",
                 shape=f"{tuple(a[2].shape)} points over "
                 f"{tuple(a[3].shape)} CDFs", **r))
    _parent_entries(by_name, "segment_slice", res["last"], gathers=(
        "cv_rows_father", "mutation_rows_father", "cv_rows_mother",
        "mutation_rows_mother"), merge="real_pass_group", count="probe",
        inherit="real_pass_group")
    # the merge over every chromosome at once, as on fresh planes
    (_, _, args, _), = res["last"]["meiose_merge"]
    planes = {k: res["planes"][0, k][1] for k in ("seg_st", "seg_hap")}
    merge = (planes["seg_st"], planes["seg_hap"], args[2], xo_f, xo_m, sh)
    cap, merge_ibd = args[6], args[7]
    shape = (f"{xo_f.shape[0]} chromosomes x {xo_f.shape[1]} children x 2 "
             f"parents of {tuple(merge[0].shape)} {merge[1].dtype} "
             f"ledgers, K {xo_f.shape[2]}, cap {cap}")
    r = _compare("meiose_merge/segment_slice/real_pass",
                 lambda: mm.meiose_merge(*merge, cap, merge_ibd),
                 lambda: mm.meiose_merge_plain(*merge, cap, merge_ibd),
                 _merge_work(*merge, cap))
    by_name["meiose_merge"].setdefault("entries", []).append(
        dict(entry="segment_slice/real_pass", shape=shape, **r))
    for m in (merge, args[:6]):
        if _max_abs_err(mm.meiose_merge(*m, cap, not merge_ibd),
                        mm.meiose_merge_plain(*m, cap, not merge_ibd)) != 0:
            raise AssertionError("meiose_merge differs from its plain "
                                 "version on the slice's ledgers, merge_ibd "
                                 f"{not merge_ibd}")
    for e in by_name["meiose_merge"]["entries"][-2:]:
        e["other_mode_exact"] = True
    return res["checked"]


def _parent_entries(by_name: dict, tag: str, last: dict, gathers=(),
                    merge=None, count=None, children_equal=False,
                    inherit=None) -> None:
    """Timed entries (`_compare`, the plain version in `_plain_chunked`'s
    chunks) for the last launches `_recheck` kept: the last
    `len(gathers)` gathers under those names, the last merge, the last
    count and the last gamete inheritance under `merge`, `count` and
    `inherit` (None: none)."""
    for (kern, plain, (table, idx), (pop, c0, c1)), what in zip(
            last["gather_rows"][-len(gathers):] if gathers else [], gathers):
        shape = (f"{idx.shape[0]} rows of {tuple(table.shape)} "
                 f"{table.dtype} (pop {pop + 1}, chromosomes {c0}-{c1 - 1})")
        r = _compare(f"gather_rows/{tag}/{what}", lambda: kern(table, idx),
                     plain, _gather_work(table, idx, 1),
                     _gather_library(table, idx, 1))
        by_name["gather_rows"].setdefault("entries", []).append(
            dict(entry=f"{tag}/{what}", shape=shape, **r))
    for k, what, work in (("merge_count", count, _count_work),
                          ("meiose_merge", merge, _merge_work)):
        if what is None:
            continue
        (kern, plain, args, (pop, c0, c1)), = last[k]
        seg_st, xo_f = args[0], args[3 if k == "meiose_merge" else 2]
        shape = (f"{c1 - c0} chromosomes ({c0}-{c1 - 1}) x {xo_f.shape[1]} "
                 f"children x 2 parents of {tuple(seg_st.shape)} ledgers, K "
                 f"{xo_f.shape[2]}"
                 + (f", {args[1].dtype} haps, cap {args[6]}"
                    if k == "meiose_merge" else ""))
        r = _compare(f"{k}/{tag}/{what}", lambda: kern(*args), plain,
                     work(*args[:7]))
        extra = dict(run_children_equal=True) if (
            children_equal and k == "meiose_merge") else {}
        by_name[k].setdefault("entries", []).append(
            dict(entry=f"{tag}/{what}", shape=shape, **extra, **r))
    if inherit is not None:
        (kern, plain, args, (pop, c0, c1)), = last["gamete_inherit"]
        pm, cv, xo = args[:3]
        shape = (f"{c1 - c0} chromosomes ({c0}-{c1 - 1}) x {xo.shape[1]} "
                 f"gametes of one parent, K {xo.shape[2]}, mutation rows "
                 f"{None if pm is None else pm.shape[-1]}, de novo slots "
                 f"{args[4].shape[-1]}, CVs "
                 f"{None if cv is None else cv.shape[-1]}")
        r = _compare(f"gamete_inherit/{tag}/{inherit}", lambda: kern(*args),
                     plain, _inherit_work(*args))
        by_name["gamete_inherit"].setdefault("entries", []).append(
            dict(entry=f"{tag}/{inherit}", shape=shape, **r))


def _paint_work(seg_st, seg_hap, mut, founder, pos) -> dict:
    # the painted bytes written once; the panel, ledgers, mutation rows and
    # positions read once; a locus's slot and mutation-pointer checks, four
    # compares an output byte
    out = seg_st.shape[0] * seg_st.shape[1] * 2 * pos.shape[1]
    return _bound(out + _nbytes(seg_st, seg_hap, mut, founder, pos), 4 * out)


def _paint_need(seg_st, seg_hap, mut, founder, pos) -> dict:
    """`_paint_work` counting, of the ledgers and mutation rows, only the
    slots before each row's first BIG (the slots that hold a segment or a
    mutation): what painting must read of them. `need_bound_ms` and
    `need_bytes`."""
    from geneevolve_tpu_torch.core.segments import BIG

    out = seg_st.shape[0] * seg_st.shape[1] * 2 * pos.shape[1]
    live = int((seg_st < BIG).sum())
    nbytes = (out + live * (4 + seg_hap.element_size())
              + 4 * int((mut < BIG).sum()) + _nbytes(founder, pos))
    b = _bound(nbytes, 4 * out)
    return dict(need_bound_ms=b["bound_ms"], need_bytes=b["bytes"])


def _paint_path(pos) -> dict:
    """The launch plan `paint` took last, and how many of its spans each
    of the kernel's paths painted (`ops/paint.span_paths`)."""
    import dataclasses

    from geneevolve_tpu_torch.ops import paint as tp

    plan = tp.paint.plan
    paths = tp.span_paths(pos, plan.span)
    spans = {k: int((paths == i).sum()) for i, k in enumerate(tp.PATHS)}
    print(f"   paint plan {dataclasses.asdict(plan)}; spans {spans}")
    return dict(plan=dataclasses.asdict(plan), spans=spans)


def _paint_entry(name: str, args) -> dict:
    """`_compare` of paint on `args`, with its need bound and share, the
    launch plan and the spans' paths."""
    from geneevolve_tpu_torch.ops import paint as tp

    r = _compare(name, lambda: tp.paint(*args), lambda: tp.paint_plain(*args),
                 _paint_work(*args), queued=True)
    r.update(_paint_need(*args), **_paint_path(args[-1]))
    r["need_share"] = r["need_bound_ms"] / r["ms"]
    q = r.get("queued_ms", {}).get("kernel")
    print(f"   need bound {r['need_bound_ms']:.4f} ms ({r['need_share']:.1%}"
          + (f"; queued {r['need_bound_ms'] / q:.1%}" if q else "") + ")")
    return r


def paint_full_width(dev, final) -> dict:
    """The paint kernel at full width on the segment slice's final ledgers
    and mutations, over a synthetic panel of 20,000 haplotypes x
    `PAINT_LOCI` loci a chromosome: positions spread over each chromosome,
    8 before its start (0), 256 at mutations its rows carry. One
    chromosome against the plain version, bit-exact and timed; all 22 in
    one launch, each chromosome bit-exact to its plain version (the plain
    time is the sum of the 22 calls). Returns the kernel's entry."""
    import torch

    from geneevolve_tpu_torch.core.segments import BIG
    from geneevolve_tpu_torch.ops import paint as tp

    seg_st, seg_hap, mut, n, chr_ends = final
    st, hp, mu = (x[:, :n].contiguous() for x in (seg_st, seg_hap, mut))
    del final, seg_st, seg_hap, mut
    C, Q, H = st.shape[0], PAINT_LOCI, 2 * SCENARIO["n0"]
    g = torch.Generator(device=dev).manual_seed(2024)
    founder = torch.randint(0, 2, (C, H, Q), generator=g, device=dev,
                            dtype=torch.uint8)
    pos = []
    for c in range(C):
        p = torch.randint(0, chr_ends[c], (Q,), generator=g, device=dev,
                          dtype=torch.int32)
        carried = mu[c][mu[c] < BIG].unique()
        k = min(256, carried.numel())
        pick = torch.randperm(carried.numel(), generator=g, device=dev)[:k]
        p[:k] = carried[pick]
        p[k:k + 8] = -torch.arange(1, 9, device=dev, dtype=torch.int32)
        pos.append(p.sort().values)
    pos = torch.stack(pos)
    one = (st[:1], hp[:1], mu[:1], founder[:1], pos[:1])
    shape = (f"{n} rows x 2 chromatids x {Q} loci, S {st.shape[-1]}, M "
             f"{mu.shape[-1]}, {hp.dtype} haps, panel {H} x {Q}")
    r = dict(name="paint", route="cuda", source=KERNELS["paint"][0],
             replaces=KERNELS["paint"][1], shape=shape,
             **_paint_entry("paint", one))
    args = (st, hp, mu, founder, pos)
    out = tp.paint(*args)
    path = _paint_path(pos)
    plain_ms = 0.0
    for c in range(C):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = tp.paint_plain(*(x[c:c + 1] for x in args))
        b.record()
        b.synchronize()
        plain_ms += a.elapsed_time(b)
        if _max_abs_err(out[c:c + 1], want) != 0:
            raise AssertionError(f"paint: chromosome {c + 1} of the 22-"
                                 "chromosome launch differs from plain")
    del out, want
    t = _time_turns({"ms": lambda: tp.paint(*args)}, {"ms": 5})
    work = dict(_paint_work(*args), **_paint_need(*args))
    r["entries"] = [dict(
        entry="all_22_chromosomes", shape=f"{C} chromosomes of {shape}",
        max_abs_err=0, ms=t["ms"], plain_ms=plain_ms, library_ms=None,
        roofline_share=work["bound_ms"] / t["ms"],
        need_share=work["need_bound_ms"] / t["ms"], **work, **path)]
    print(f" kernel paint/all_22_chromosomes      {t['ms']:.4f} ms   plain "
          f"{plain_ms:.1f} ms (22 calls)   bound {work['bound_ms']:.4f} ms "
          f"({work['bound_ms'] / t['ms']:.1%}), need bound "
          f"{work['need_bound_ms']:.4f} ms; 22 chromosomes bit-exact")
    print(f"   ({shape})")
    return r


def segment_gather(dev, work: Path, base: list, resident_root: Path) -> dict:
    """The segment slice again under GE_NO_RESIDENT_CV=1: the gather path,
    A/D painted from the ledger. Its `.info` and `.summary` must equal the
    resident run's byte for byte (the same draws, and the painted alleles
    are the resident ones). The last generation's paint inputs are kept
    under `captured`, its launches that read the parents under `parents`
    (`_ParentLaunches`)."""
    import filecmp
    import os

    os.environ["GE_NO_RESIDENT_CV"] = "1"
    try:
        with _ParentLaunches(SCENARIO["gens"]) as rec:
            out = slice_phase(dev, work, "gather31", SCENARIO, base=base,
                              before_step=rec.before_step)
    finally:
        del os.environ["GE_NO_RESIDENT_CV"]
    sim = out.pop("sim")
    st = sim.pops[0].state
    if sim.resident_cv or st.cv is not None:
        raise AssertionError("gather path: the resident matrix was kept")
    if any(c["seg_need"] != c["seg_used"] for c in sim.capacity_log):
        raise AssertionError(f"capacity tripwire: {sim.capacity_log}")
    names = [f"out.info.pop1.gen{g}.txt" for g in range(sim.tot_gen + 1)]
    for x in names + ["out.pop1.summary"]:
        if not filecmp.cmp(resident_root / x, out["root"] / x,
                           shallow=False):
            raise AssertionError(f"gather path: {x} differs from the "
                                 "resident run's")
    print(f" gather31: {len(names)} .info files and the .summary "
          "byte-identical to the resident run's")
    out["captured"] = (st.seg_st, st.seg_hap, st.mut, sim._cv_panels[0],
                       sim.cv_bp_all[:, :sim.ncv_pad].contiguous())
    out["parents"] = rec
    return out


def segment_grow(dev, work: Path, slice_argv: list) -> dict:
    """The slice for `GROW_GENS` generations with the ledger capacity S cut
    to `GROW_S_CAP` after loading, so that a generation outgrows it: that
    generation (`[capacity grow]`) pads the ledgers into new planes beside
    the old before writing its children in place, and its peak is printed
    beside the other generations'. The slice's checks and the tripwire
    hold; the launches expected follow from the capacity log. The last
    generation's launches that read the parents are kept under `parents`
    (`_ParentLaunches`)."""
    from geneevolve_tpu_torch.core import engine

    scenario = dict(SCENARIO, gens=GROW_GENS)
    root = work / "grow31"
    root.mkdir(parents=True, exist_ok=True)
    base = _with(slice_argv, "--file_gen_info",
                 str(_popinfo(root, scenario, GROW_GENS)))
    load = engine.Simulation._load

    def load_rec(self):
        load(self)
        self.s_cap = GROW_S_CAP

    engine.Simulation._load = load_rec
    try:
        with _ParentLaunches(GROW_GENS) as rec:
            out = slice_phase(dev, work, "grow31", scenario, base=base,
                              before_step=rec.before_step)
    finally:
        engine.Simulation._load = load
    sim = out.pop("sim")
    log = sim.capacity_log
    grown = [c["gen"] for c in log if c["s_cap"] > GROW_S_CAP]
    if not grown or any(c["seg_need"] != c["seg_used"] for c in log):
        raise AssertionError(f"grow31: no capacity grow, or the tripwire: "
                             f"{log}")
    g = grown[0]
    peaks = [x["gen"] for x in out["peaks_per_gen_mb"]]
    out.update(parents=rec, grow_gen=g, grow_peak_mb=peaks[g - 1], s_caps=[
        c["s_cap"] for c in log], want_launches=_launches_from_log(log,
                                                                   False))
    print(f" grow31: S grew from {GROW_S_CAP} to {log[g - 1]['s_cap']} at "
          f"generation {g}; its peak {peaks[g - 1]:.1f} MiB, the other "
          "generations' " + ", ".join(f"{x:.1f}" for i, x in enumerate(peaks)
                                      if i != g - 1) + " MiB")
    return out


def gather_paint_kernel(kernels: list, captured) -> None:
    """The paint kernel at the gather path's shape, on its last
    generation's own inputs (22 chromosomes x 100 CV columns), bit-exact;
    added to the kernel's `entries`."""
    st, hp, mu, founder, pos = captured
    shape = (f"{st.shape[0]} chromosomes x {st.shape[1]} rows x 2 x "
             f"{pos.shape[1]} CVs, S {st.shape[-1]}, panel "
             f"{founder.shape[1]} x {founder.shape[2]}")
    r = _paint_entry("paint/gather_path", captured)
    by_name = {k["name"]: k for k in kernels}
    by_name["paint"].setdefault("entries", []).append(
        dict(entry="gather_path", shape=shape, **r))
    print(f"   ({shape})")


# ------------------------------------------------------ several populations
def _write_hap(path: Path, mat) -> None:
    """A `.hap` text file of the (rows, haplotypes) 0/1 matrix, in
    `tools/mkscenario.py`'s format."""
    import numpy as np

    n = mat.shape[1]
    body = np.full((mat.shape[0], 2 * n + 1), ord(" "), dtype=np.uint8)
    body[:, 0:2 * n:2] = mat + ord("0")  # each allele followed by a space
    body[:, -1] = ord("\n")
    path.write_bytes(body.tobytes())


def _second_population(root: Path, scenario: dict, seed: int) -> list:
    """Population 2 of a two-population run: `tools/mkscenario.py` with the
    first population's seed (so the same CV positions, maps and legends),
    then fresh founder alleles (the CV haps; on a real panel the panel's,
    with the CVs moved onto its own sites, which are the first
    population's) and fresh effects in its own `cv.info`: equal tables
    would make a wrong root population invisible."""
    import numpy as np

    sys.path.insert(0, str(REPO / "tools"))
    from mkscenario import make_scenario

    sc = dict(scenario)
    on_panel = sc.pop("cvs_on_panel", False)
    flags = make_scenario(str(root), **sc, seed=1)
    rng = np.random.default_rng(seed)
    nchr, H = sc["nchr"], 2 * sc["n0"]
    head, *rows = (root / "cv.info").read_text().splitlines()
    (root / "cv.info").write_text("\n".join([head] + [
        " ".join(r.split()[:2] + [f"{rng.normal():.6f}", "0"])
        for r in rows]) + "\n")
    for c in range(1, nchr + 1):
        if on_panel:
            _write_hap(root / f"ref.chr{c}.hap", rng.integers(
                0, 2, size=(sc["snps"], H), dtype=np.uint8))
        else:
            _write_hap(root / f"cv.chr{c}.hap", rng.integers(
                0, 2, size=(sc["ncv"], H), dtype=np.uint8))
    if on_panel:
        _cvs_on_panel(root, 1)
    flags["file_mutation_map"] = str(
        _mutation_map(root / "mut.txt", Path(flags["file_recom_map"])))
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    return argv


def _two_populations(root: Path, pop1: list, scenario: dict, gens: int,
                     pop_flags=()) -> list:
    """The argv of a two-population run: `pop1`'s flags, then a second
    population (`_second_population`), both `gens` generations, migration
    `0.9 0.1 0.1 0.9` every generation and `--gamma 0.5`."""
    root.mkdir(parents=True, exist_ok=True)
    pop2 = _second_population(root / "pop2", scenario, seed=2)
    info = str(_popinfo(root, scenario, gens))
    (root / "migration.txt").write_text("0.9 0.1 0.1 0.9\n" * gens)
    return (_with(pop1, "--file_gen_info", info) + list(pop_flags)
            + ["--next_population"]
            + _with(pop2, "--file_gen_info", info) + list(pop_flags)
            + ["--file_migration", str(root / "migration.txt"),
               "--gamma", "0.5"])


def _check_multipop(name: str, sim, root: Path, scenario: dict) -> dict:
    """Both populations' outputs: sizes, finite values, the other
    population's founder haps (or, dense, rows) in each, and population
    means of P apart (gamma)."""
    import numpy as np

    means, sds = [], []
    for p in (1, 2):
        for gen in range(sim.tot_gen + 1):
            _, info = _read_table(root / f"out.info.pop{p}.gen{gen}.txt")
            want = scenario["n0"] if gen == 0 else scenario["pop_size"]
            if abs(info.shape[0] - want) > 6 * want ** 0.5 + 0.1 * want \
                    or not np.isfinite(info).all():
                raise AssertionError(f"{name}: pop {p} gen {gen}: "
                                     f"{info.shape[0]} rows")
        means.append(info[:, 14].mean())  # P of phenotype 1
        sds.append(info[:, 14].std())
    if abs(means[0] - means[1]) < 0.5 * max(sds):
        raise AssertionError(f"{name}: population means of P {means} "
                             f"(sd {sds}): gamma did not separate them")
    print(f" {name}: population means of P {means[0]:.3f} / "
          f"{means[1]:.3f} (sd {sds[0]:.3f} / {sds[1]:.3f})")
    return dict(mean_P=means, sd_P=sds)


def _launches_from_log(log: list, gather_path: bool) -> dict:
    """The stacked kernels' launches a run's reproduce passes make, from
    its capacity log (whether each (generation, population) ran in place
    and drew its plan a group at a time): whole plan, 3 draws and 1
    count; per group, twice 3 draws and 1 count a group; fresh planes, 1 merge,
    a gather a parent and table and a gamete inheritance a parent; in
    place, those a group."""
    tables = 1 if gather_path else 2
    out = {"point_draws": 0, "merge_count": 0, "gather_rows": 0,
           "meiose_merge": 0, "gamete_inherit": 0}
    for c in log:
        groups = GROUPS if c["in_place"] else 1
        out["point_draws"] += 2 * 3 * GROUPS if c["per_group"] else 3
        out["merge_count"] += GROUPS if c["per_group"] else 1
        out["meiose_merge"] += groups
        out["gather_rows"] += 2 * tables * groups
        out["gamete_inherit"] += 2 * groups
    return out


def segment_multipop(dev, work: Path, slice_argv: list) -> dict:
    """Two populations at the slice's full width (each 10,000 founders,
    pop_size 30,000, 22 chromosomes x 100 CVs, the slice's mutation map), 3
    generations, migration and gamma, `--checkpoint_every 2`: the gather
    path with int32 haps (H 40,000). Checks each population's outputs, the
    other population's founder haps in each final ledger, gamma, and the
    capacity tripwire; times the checkpoint saves. Keeps under `captured`
    the last generation's launches that read the parents
    (`_ParentLaunches`) and its last two paints' inputs (references)."""
    import torch

    from geneevolve_tpu_torch.core import checkpoint, engine

    scenario = dict(SCENARIO, gens=MULTIPOP_GENS)
    base = _two_populations(work / "multipop31", slice_argv, scenario,
                            MULTIPOP_GENS)
    captured, saves = {"paint": []}, []
    paint, save = engine.paint, checkpoint.save

    def paint_rec(*a):
        captured["paint"] = (captured["paint"] + [a])[-2:]
        return paint(*a)

    def save_rec(sim, gen, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(sim, gen, path)
        saves.append(dict(gen=gen, s=time.perf_counter() - t0,
                          mb=Path(path).stat().st_size / 2**20))

    engine.paint, checkpoint.save = paint_rec, save_rec
    try:
        with _ParentLaunches(MULTIPOP_GENS) as rec:
            out = slice_phase(dev, work, "multipop31", scenario,
                              ["--checkpoint_every", "2"], base=base,
                              before_step=rec.before_step)
    finally:
        engine.paint, checkpoint.save = paint, save
    sim = out.pop("sim")
    H = 2 * sum(p.n_founders for p in sim.pops)
    if sim.n_pop != 2 or sim.resident_cv or sim.hap_dtype != (
            torch.int32 if H > 32_000 else torch.int16):
        raise AssertionError("multipop31: two populations on the gather "
                             f"path, {sim.hap_dtype} haps for H {H}")
    log = sim.capacity_log
    if len(log) != MULTIPOP * MULTIPOP_GENS or any(
            c["seg_need"] != c["seg_used"] for c in log):
        raise AssertionError(f"multipop31: capacity tripwire: {log}")
    split = int(sim.pop_starts[1])
    for p in sim.pops:
        st = p.state
        haps = st.seg_hap[:, : st.n][st.seg_st[:, : st.n] < 2**30]
        other = (haps >= split) if p.index == 0 else (haps < split)
        share = float(other.float().mean())
        if share <= 0:
            raise AssertionError(f"multipop31: pop {p.index + 1} holds no "
                                 "founder hap of the other population")
        print(f" multipop31: pop {p.index + 1}: {share:.2%} of its ledger "
              "segments from the other population's founders")
        out.setdefault("other_share", []).append(share)
    out.update(_check_multipop("multipop31", sim, out["root"], scenario))
    if [s["gen"] for s in saves] != [0, 2]:
        raise AssertionError(f"multipop31: checkpoints after {saves}")
    out["checkpoint_saves"] = saves
    print(" multipop31: checkpoint " + ", ".join(
        f"gen {s['gen']}: {s['mb']:.1f} MiB in {s['s']:.2f} s"
        for s in saves))
    print(f" multipop31: migration stage "
          f"{sim.timer.totals.get('migration', 0.0):.4f} s over "
          f"{MULTIPOP_GENS} generations")
    captured["parents"] = rec
    captured["want_checked"] = {k: v for k, v in _launches_from_log(
        [c for c in log if c["gen"] == MULTIPOP_GENS], True).items()
        if k in PARENT_KERNELS}
    out["captured"] = captured
    out["ckpt"] = str(out["root"] / "out.ckpt.npz")
    # with migration a generation keeps its rows (and runs in place) only
    # when its children fit the rows the migration left
    out["want_launches"] = dict(_launches_from_log(log, True),
                                paint=2 * len(log) + GEN0_LAUNCHES[
                                    "segment_multipop"]["paint"])
    out["in_place"] = [c["in_place"] for c in log]
    return out


def segment_multipop_resume(dev, straight: dict) -> dict:
    """A fresh `Simulation` resumed from `segment_multipop`'s generation-2
    checkpoint runs generation 3: its `.info` and `.summary` files must
    equal the straight run's byte for byte."""
    import filecmp

    import torch

    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.core import checkpoint
    from geneevolve_tpu_torch.core.engine import Simulation

    root = straight["root"] / "resume"
    root.mkdir()
    argv = straight["argv"] + ["--seed", "12345", "--prefix",
                               str(root / "out"), "--resume",
                               straight["ckpt"]]
    loads, load = [], checkpoint.load

    def load_rec(sim, path):
        t0 = time.perf_counter()
        done = load(sim, path)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return done

    checkpoint.load = load_rec
    try:
        t0 = time.perf_counter()
        sim = Simulation(parse_args(argv), device=dev, verbose=False)
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        checkpoint.load = load
    names = [f"out.{x}" for p in (1, 2)
             for x in (f"pop{p}.summary", f"info.pop{p}.gen{MULTIPOP_GENS}"
                       ".txt")]
    for x in names:
        if not filecmp.cmp(straight["root"] / x, root / x, shallow=False):
            raise AssertionError(f"multipop31 resume: {x} differs from the "
                                 "straight run's")
    mb = Path(straight["ckpt"]).stat().st_size / 2**20
    print(f" multipop31 resume: {len(names)} files byte-identical to the "
          f"straight run's; checkpoint {mb:.1f} MiB loaded in "
          f"{loads[0]:.2f} s; resumed run {wall:.1f} s")
    log = sim.capacity_log
    return dict(load_s=loads[0], checkpoint_mb=mb, wall_s=wall,
                want_launches=dict(_launches_from_log(log, True),
                                   paint=2 * len(log)),
                in_place=[c["in_place"] for c in log])


def multipop_kernels(kernels: list, captured: dict) -> dict:
    """On `segment_multipop`'s last generation: every launch that read
    the parents (both populations' counts, merges and gathers) made again
    on its own inputs (`_recheck`; the parents' planes from the host copy
    taken before that generation), bit-exact, the last count and merge
    (int32 haps) timed; and both paints of the A/D (alleles; roots over
    the root panel with M = 0) against their plain versions; added to the
    kernels' `entries`."""
    import torch

    by_name = {k["name"]: k for k in kernels}
    res = _recheck("multipop31", captured["parents"])
    if res["checked"] != captured["want_checked"]:
        raise AssertionError(f"multipop31: last generation's launches "
                             f"{res['checked']}, "
                             f"{captured['want_checked']} expected")
    (_, _, merge, _), = res["last"]["meiose_merge"]
    if merge[1].dtype != torch.int32 and 2 * MULTIPOP * SCENARIO["n0"] > 32000:
        raise AssertionError(f"multipop: {merge[1].dtype} haps")
    _parent_entries(by_name, "segment_multipop", res["last"],
                    merge="int32_haps", count="int32_haps")
    for args, what in zip(captured["paint"], ("alleles", "roots_m0")):
        st, _hp, mu, founder, pos = args
        shape = (f"{st.shape[0]} chromosomes x {st.shape[1]} rows x 2 x "
                 f"{pos.shape[1]} CVs, S {st.shape[-1]}, M {mu.shape[-1]}, "
                 f"panel {founder.shape[1]} x {founder.shape[2]}, int32 haps")
        r = _paint_entry(f"paint/multipop/{what}", args)
        by_name["paint"].setdefault("entries", []).append(
            dict(entry=f"segment_multipop/{what}", shape=shape, **r))
        print(f"   ({shape})")
    if captured["paint"][1][2].shape[-1] != 0 or \
            int(captured["paint"][1][3].max()) != MULTIPOP - 1:
        raise AssertionError("multipop: the root paint is not over an "
                             "M = 0 plane and a root panel")
    return res["checked"]


# ------------------------------------------------------------ biobank n
def _largest_n(sim, free: int) -> dict:
    """The largest population each path admits at this run's shape and
    capacities by `memory.reckon`, with `free` bytes free a card: resident
    or gather path, in place or on fresh planes, on 1, 2 and 4 'ind'
    ranks (a card each)."""
    import dataclasses

    import numpy as np

    from geneevolve_tpu_torch.core import memory

    base = sim._sizes()

    def admits(n, ind, resident, in_place):
        rows = n + 4 * int(np.sqrt(n)) + 16
        plan = memory.reckon(dataclasses.replace(base, pop_rows=(rows,),
                                                 ind=ind),
                             free, memory.Switches(in_place=in_place),
                             resident)
        return plan.resident_cv == resident and plan.need <= free

    out = {}
    for ind in (1, 2, 4):
        got = out[f"ind{ind}"] = {}
        for resident, in_place in itertools.product((True, False),
                                                    repeat=2):
            lo, hi = 1, 1 << 30
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = ((mid, hi) if admits(mid, ind, resident, in_place)
                          else (lo, mid))
            got[f"{'resident' if resident else 'gather'}_"
                f"{'in_place' if in_place else 'fresh'}"] = lo
    return out


def biobank_phase(dev, work: Path, name: str, slice_argv: list,
                  fresh: bool = False) -> dict:
    """`name` of `BIOBANK` over the slice's scenario files (10,000
    founders, 22 chromosomes x 100 CVs, the slice's mutation map), 3
    generations through the CLI with `--stage_sync`: in place with the
    per-group plan (300,000 is past the JAX package's 1.5e9 bytes of plan),
    or, `fresh`, under GE_NO_INPLACE_REPRO=1 GE_PLAN_PER_GROUP=0. Keeps
    the last generation's launches that read the parents
    (`_ParentLaunches`: its parents' planes copied to the host before it,
    outside its timing) under `parents` for `biobank_kernels`."""
    import os

    import torch

    n = BIOBANK[name]
    scenario = dict(SCENARIO, pop_size=n, gens=BIOBANK_GENS)
    root = work / name
    root.mkdir(parents=True, exist_ok=True)
    base = _with(slice_argv, "--file_gen_info",
                 str(_popinfo(root, scenario, BIOBANK_GENS)))
    env = ({"GE_NO_INPLACE_REPRO": "1", "GE_PLAN_PER_GROUP": "0"} if fresh
           else {})
    saved = {k: os.environ.get(k) for k in env}
    free = torch.cuda.mem_get_info(dev)[0]
    os.environ.update(env)
    try:
        with _ParentLaunches(BIOBANK_GENS) as rec:
            out = slice_phase(dev, work, name, scenario, base=base,
                              before_step=rec.before_step)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sim = out.pop("sim")
    plan = sim.mem_plan
    if (plan.in_place, plan.per_group, plan.resident_cv) != (
            not fresh, not fresh, True):
        raise AssertionError(f"{name}: memory plan {plan}")
    if any(c["seg_need"] != c["seg_used"] for c in sim.capacity_log):
        raise AssertionError(f"{name}: tripwire {sim.capacity_log}")
    out.update(parents=rec, free_before_mb=free / 2**20)
    if name == "biobank_1m":
        out["largest_n"] = _largest_n(sim, free)
        print(f" {name}: the largest population each path admits at this "
              f"shape by the reckoning, {free / 2**30:.1f} GiB free a card, "
              "on 1, 2 and 4 'ind' ranks: " + json.dumps(out["largest_n"]))
    per_gen = statistics.median(out["s_per_gen"])
    print(f" {name}: {per_gen:.3f} s/gen (median of {BIOBANK_GENS}) on the "
          f"card; the reference's CPU binary at 300,000: "
          f"{REFERENCE_300K_S} s/gen (BASELINE.md)")
    return out


def biobank_kernels(kernels: list, name: str, rec, per_gen: dict) -> dict:
    """Every launch of `name`'s last generation that read the parents,
    made again on its real inputs at its full shape (`_recheck`): in place
    each group's count, merge and 4 gathers; on fresh planes the count,
    the merge and the gathers over every chromosome; each equal to its
    plain version (in `_plain_chunked`'s chunks past 2^20 chromosome and
    child rows), each merge equal to every row of the children the run
    wrote. Timed into the kernels' `entries`: the last merge, the last
    count, the last 2 gathers and the draws of the last launch's plan."""
    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.ops import point_draws as pd

    res = _recheck(name, rec, children=True)
    want = {k: per_gen[k] for k in PARENT_KERNELS}
    if res["checked"] != want:
        raise AssertionError(f"{name}: last generation's launches "
                             f"{res['checked']}, {want} expected")
    by_name = {k["name"]: k for k in kernels}
    _parent_entries(by_name, name, res["last"],
                    gathers=("cv_rows_mother", "mutation_rows_mother"),
                    merge="real_pass", count="probe", children_equal=True,
                    inherit="real_pass")
    (_, _, _, (pop, c0, c1)), = res["last"]["meiose_merge"]
    sim = rec.sim
    p, gen, n_pad = rec.plans[pop]
    drawn, draws = [], segments.point_draws
    del res
    segments.point_draws = lambda *a: drawn.append(a) or draws(*a)
    try:
        sim._plan(p, gen, n_pad, c0, c1)
    finally:
        segments.point_draws = draws
    a = drawn[0]
    del drawn
    r = _compare(f"point_draws/{name}/crossovers_father",
                 lambda: pd.point_draws(*a), lambda: pd.point_draws_plain(*a),
                 _draws_work(*a), _draws_library(a))
    by_name["point_draws"].setdefault("entries", []).append(
        dict(entry=f"{name}/crossovers_father",
             shape=f"{tuple(a[2].shape)} points over {tuple(a[3].shape)} "
             f"CDFs (chromosomes {c0}-{c1 - 1}, every child)", **r))
    return want


def biobank_phases(dev, work: Path, slice_argv: list, wrappers: dict,
                   launches: dict, kernels: list) -> dict:
    """`table31_300k`, `table31_300k_fresh` (files byte-identical to
    `table31_300k`'s, a larger peak) and `biobank_1m`, each counted, its
    kernels re-checked at full shape after it, its files deleted after
    (`table31_300k`'s, and its argv, kept for `table31_300k_mesh2`)."""
    import shutil

    import torch

    res = {}
    for name in BIOBANK:
        torch.cuda.empty_cache()
        res[name] = counted(name, wrappers, lambda: biobank_phase(
            dev, work, name, slice_argv, fresh=name.endswith("_fresh")),
            launches)
        per_gen = (SEGMENT_FRESH_PER_GEN if name.endswith("_fresh")
                   else PER_GROUP_PER_GEN)
        _expect(name, launches[name],
                {k: v * BIOBANK_GENS for k, v in per_gen.items()})
        out = res[name]
        out["parent_launches_checked"] = biobank_kernels(
            kernels, name, out.pop("parents"), per_gen)
        torch.cuda.empty_cache()
        out.pop("gen0_launches")
        if name != "table31_300k":  # its files and argv: the mesh run's
            out.pop("argv")
        if name == "table31_300k_fresh":
            a = res["table31_300k"]
            _same_files(name, a["root"], out["root"],
                        _info_files(1, BIOBANK_GENS) + ["out.pop1.summary"])
            if not a["max_memory_allocated_mb"] < \
                    out["max_memory_allocated_mb"]:
                raise AssertionError(
                    f"{name}: in place peaks at "
                    f"{a['max_memory_allocated_mb']:.1f} MiB, fresh planes "
                    f"at {out['max_memory_allocated_mb']:.1f}")
            print(f" table31_300k: .info/.summary byte-identical in place "
                  f"and on fresh planes; peak "
                  f"{a['max_memory_allocated_mb']:.1f} MiB in place against "
                  f"{out['max_memory_allocated_mb']:.1f}; s/gen "
                  + " ".join(f"{x:.3f}" for x in a["s_per_gen"]) + " against "
                  + " ".join(f"{x:.3f}" for x in out["s_per_gen"]))
            shutil.rmtree(out.pop("root"))
    shutil.rmtree(res["biobank_1m"].pop("root"))
    torch.cuda.empty_cache()
    return res


def multipop_parity_phase(dev, work: Path) -> int:
    """Two populations at the parity phase's small size on `dev` and on the
    CPU, the device run fed the CPU run's mating and reproduce plans per
    (generation, population): identical planes every generation, after
    migration too. Returns generations checked."""
    import torch

    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.core.engine import Simulation

    root = work / "multipop_parity"
    small = dict(n0=200, pop_size=300, gens=3, nchr=3, ncv=12)
    pop1 = _scenario(root / "pop1", **small, seed=1)
    argv = _two_populations(root, pop1, small, small["gens"])
    sims = {}
    for name, d in (("cpu", "cpu"), ("dev", dev)):
        cfg = parse_args(argv + ["--seed", "7", "--prefix",
                                 str(root / name)])
        sims[name] = Simulation(cfg, device=d, verbose=False)
    ref, sim = sims["cpu"], sims["dev"]
    mates, plans = {}, {}
    ref_mate, ref_plan = ref._mate, ref._plan
    ref._mate = lambda p, gen, ps, g: mates.setdefault(
        (gen, p.index), ref_mate(p, gen, ps, g))
    ref._plan = lambda p, gen, n_pad: plans.setdefault(
        (gen, p.index), ref_plan(p, gen, n_pad))
    sim._mate = lambda p, gen, ps, g: mates[(gen, p.index)]
    sim._plan = lambda p, gen, n_pad: tuple(
        x.to(dev) for x in plans[(gen, p.index)])
    for s in (ref, sim):
        s.init_generation0()
    for gen in range(ref.tot_gen + 1):
        if gen:
            ref.step(gen)
            sim.step(gen)
        for a, b in zip(ref.pops, sim.pops):
            for k in ("seg_st", "seg_hap", "mut"):
                if not torch.equal(getattr(a.state, k),
                                   getattr(b.state, k).cpu()):
                    raise AssertionError(f"multipop parity: {k} of pop "
                                         f"{a.index + 1} differs at gen {gen}")
            if a.state.ids.tolist() != b.state.ids.tolist():
                raise AssertionError("multipop parity: migrants differ")
    split = int(ref.pop_starts[1])
    if not bool((ref.pops[0].state.seg_hap >= split).any()):
        raise AssertionError("multipop parity: no migrant ancestry")
    for s in (ref, sim):
        s.write_summary()
        s._io_pool.shutdown(wait=True)
    print(f" multipop parity: cuda == cpu for gens 0..{ref.tot_gen}, both "
          "populations (ledgers, mutations, migrants)")
    return ref.tot_gen + 1


def dense_multipop(dev, work: Path, dense_argv: list) -> dict:
    """The dense slice's shape with two populations (each 2,000 founders x
    2,048 SNPs a chromosome at identical loci; population 2 with fresh
    alleles and effects, its CVs on its own panel's sites), 3 generations,
    migration and gamma: each population's resident CVs equal its planes',
    and one packed meiosis a generation and population."""
    import torch

    from geneevolve_tpu_torch.dense import packed
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed

    scenario = dict(DENSE_SCENARIO, gens=MULTIPOP_GENS)
    base = _two_populations(work / "dense_multipop31", dense_argv, scenario,
                            MULTIPOP_GENS, DENSE_VARIANCES)
    out = slice_phase(dev, work, "dense_multipop31", scenario,
                      ["--backend", "dense"], base=base)
    sim = out.pop("sim")
    want = MULTIPOP * MULTIPOP_GENS
    if meiose_packed.launches != want:
        raise AssertionError(f"dense_multipop31: {meiose_packed.launches} "
                             f"packed meiosis launches, {want} expected")
    for p in sim.pops:
        for j, cols in enumerate(sim.dps[p.index].cv_cols):
            if not torch.equal(p.state.cv[j],
                               packed.cv_from_planes(p.state.hap, cols)):
                raise AssertionError(f"dense_multipop31: pop {p.index + 1}'s"
                                     " resident CVs differ from its planes'")
    print(" dense_multipop31: each population's resident CVs == its planes' "
          "CVs")
    out.update(_check_multipop("dense_multipop31", sim, out["root"],
                               scenario))
    del out["argv"], out["root"]
    return out


def _vcf_panel(root: Path) -> Path:
    """VCF copies of a scenario's `.hap` founder panels (sample names from
    its `.indv`, QUAL 30, FILTER PASS) and their address file."""
    import numpy as np

    from geneevolve_tpu_torch.io import hap as hap_io

    lines = (root / "hap_address.txt").read_text().split("\n")[1:]
    addr = root / "vcf_address.txt"
    with open(addr, "w") as fa:
        fa.write("chr vcf\n")
        for line in filter(None, lines):
            c, hap_path, legend_path, indv_path = line.split()
            hap = hap_io.read_hap(hap_path)  # (2n, m)
            leg = hap_io.read_legend(legend_path)
            samples = hap_io.read_indv(indv_path)
            gt = np.char.add(np.char.add(hap[0::2].T.astype("U1"), "|"),
                             hap[1::2].T.astype("U1"))
            with open(root / f"ref.chr{c}.vcf", "w") as f:
                f.write("##fileformat=VCFv4.1\n##Phasing=phased\n")
                f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                        "\tFORMAT\t" + "\t".join(samples) + "\n")
                for j in range(len(leg.pos)):
                    f.write(f"{c}\t{leg.pos[j]}\t{leg.ids[j]}\t{leg.al0[j]}"
                            f"\t{leg.al1[j]}\t30\tPASS\t.\tGT\t"
                            + "\t".join(gt[j]) + "\n")
            fa.write(f"{c} {root}/ref.chr{c}.vcf\n")
    return addr


def _cpu_card_files(dev, root: Path, argv: list, sim_cls) -> list:
    """`argv` run by `sim_cls` on the CPU, then on `dev` fed the CPU run's
    mating plans and draws; every genotype file byte-identical. Returns the
    file names compared."""
    import filecmp

    from geneevolve_tpu_torch.config import parse_args

    sims = {}
    for name, d in (("cpu", "cpu"), ("dev", dev)):
        (root / name).mkdir(parents=True)
        cfg = parse_args(argv + ["--prefix", str(root / name / "out")])
        sims[name] = sim_cls(cfg, device=d, verbose=False)
    ref, sim = sims["cpu"], sims["dev"]
    mates, plans = {}, {}
    ref_mate, ref_plan = ref._mate, ref._plan
    ref._mate = lambda p, gen, ps, g: mates.setdefault(
        gen, ref_mate(p, gen, ps, g))
    ref._plan = lambda p, gen, n_pad: plans.setdefault(
        gen, ref_plan(p, gen, n_pad))
    sim._mate = lambda p, gen, ps, g: mates[gen]
    sim._plan = lambda p, gen, n_pad: tuple(
        None if x is None else x.to(dev) for x in plans[gen])
    ref.run()
    sim.run()
    names = sorted(x.name for x in (root / "cpu").iterdir())
    if names != sorted(x.name for x in (root / "dev").iterdir()):
        raise AssertionError(f"{root.name}: different file sets")
    geno = [x for x in names
            if not (x.startswith("out.info.") or x.endswith(".summary"))]
    for x in geno:
        if not filecmp.cmp(root / "cpu" / x, root / "dev" / x,
                           shallow=False):
            raise AssertionError(f"{root.name}: {x} differs")
    return geno


def segment_output_parity(dev, work: Path) -> int:
    """Segment-backend genotype output on `dev` against the CPU (plain
    versions): all output flags, then `--out_plink01`, then a
    `--file_ref_vcf` panel on the segment and the dense backend; every
    genotype file byte-identical. Returns the files compared."""
    from geneevolve_tpu_torch.core.engine import Simulation
    from geneevolve_tpu_torch.dense.backend import DenseSimulation

    root = work / "output_parity"
    base = _scenario(root, n0=200, pop_size=300, gens=3, nchr=3, ncv=12,
                     snps=256, seed=3) + ["--seed", "7"]
    (root / "gens.txt").write_text("2\n3\n")
    vcf = str(_vcf_panel(root))
    i = base.index("--file_hap_name")
    ref_vcf = base[:i] + base[i + 2:] + ["--file_ref_vcf", vcf]
    runs = {
        "all_flags": (base + ["--out_hap", "--out_vcf", "--out_plink",
                              "--out_interval", "--debug",
                              "--file_output_generations",
                              str(root / "gens.txt")], Simulation, 2 * 3 * 6
                      + 3),
        "plink01": (base + ["--out_plink01"], Simulation, 3 * 2),
        "ref_vcf_segment": (ref_vcf + ["--out_vcf", "--out_hap"], Simulation,
                            3 * 3),
        "ref_vcf_dense": (ref_vcf + ["--backend", "dense", "--out_vcf",
                                     "--out_plink"], DenseSimulation, 3 * 3),
    }
    total = 0
    for name, (argv, cls, want) in runs.items():
        geno = _cpu_card_files(dev, root / name, argv, cls)
        if len(geno) != want:
            raise AssertionError(f"output parity {name}: files {geno}")
        total += len(geno)
        print(f" output parity {name}: {len(geno)} genotype files "
              "byte-identical, cuda == cpu")
    return total


def segment_output_full(dev, work: Path, dense_argv: list) -> dict:
    """The segment CLI over the dense slice's scenario files (30,000 pop,
    2,000 founders, 22 x 2,048 SNPs), 3 generations, `--out_vcf
    --out_interval` at generation 3 only: file and line counts, the VCF
    sample columns, every `.int` row count against the final ledger and
    the chains (`en` of a row is `st` of the next of its chromatid) of
    chromosomes 1 and 22, the tripwire in `merge_ibd=False` mode, and the
    output stage's split, with the time the VCF writer spends formatting
    genotypes (`vcf._gt_tails`) and this disk's write rate beside it. The
    files are deleted after the checks."""
    import os

    import numpy as np

    from geneevolve_tpu_torch import native
    from geneevolve_tpu_torch.core.segments import BIG
    from geneevolve_tpu_torch.io import vcf as vcf_io

    root = work / "output31"
    root.mkdir()
    probe = root / "disk_probe.bin"
    t0 = time.perf_counter()
    with open(probe, "wb") as f:
        for _ in range(16):
            f.write(bytes(64 << 20))
        f.flush()
        os.fsync(f.fileno())
    disk_mb_s = 1024 / (time.perf_counter() - t0)
    probe.unlink()
    tails, fmt_s = vcf_io._gt_tails, [0.0]

    def tails_rec(a, b):
        t = time.perf_counter()
        out = tails(a, b)
        fmt_s[0] += time.perf_counter() - t
        return out

    vcf_io._gt_tails = tails_rec
    (root / "gens.txt").write_text(f"{OUTPUT_GENS}\n")
    base = _with(dense_argv, "--file_gen_info",
                 str(_popinfo(root, DENSE_SCENARIO, OUTPUT_GENS)))
    try:
        out = slice_phase(dev, work, "output31", DENSE_SCENARIO, base=base,
                          extra=["--out_vcf", "--out_interval",
                                 "--file_output_generations",
                                 str(root / "gens.txt"), *DENSE_VARIANCES])
    finally:
        vcf_io._gt_tails = tails
    sim = out.pop("sim")
    st, n = sim.pops[0].state, sim.pops[0].state.n
    if sim.merge_ibd or any(c["seg_used"] > c["seg_need"]
                            for c in sim.capacity_log):
        raise AssertionError(f"output31: tripwire {sim.capacity_log}")
    files = sorted(x.name for x in root.iterdir()
                   if x.suffix in (".vcf", ".int"))
    want = sorted(f"out.pop1.gen{OUTPUT_GENS}.chr{c}.{s}" for c in sim.chrs
                  for s in ("vcf", "int"))
    if files != want:
        raise AssertionError(f"output31: files {files}")
    size = sum((root / x).stat().st_size for x in files)
    lines = {}
    for ic, c in enumerate(sim.chrs):
        with open(root / f"out.pop1.gen{OUTPUT_GENS}.chr{c}.vcf", "rb") as f:
            k = 0
            for line in f:
                if line.startswith(b"#CHROM"):
                    cols = line.split(b"\t")
                    if len(cols) != 9 + n or cols[9] != b"g3_1" or \
                            cols[-1].strip() != f"g3_{n}".encode():
                        raise AssertionError("output31: VCF samples")
                elif not line.startswith(b"#"):
                    k += 1
        if k != DENSE_SCENARIO["snps"]:
            raise AssertionError(f"output31: chr {c} VCF has {k} records")
        path = root / f"out.pop1.gen{OUTPUT_GENS}.chr{c}.int"
        with open(path, "rb") as f:
            k = sum(1 for _ in f) - 1
        slots = int((st.seg_st[ic, :n] < BIG).sum())
        if k != slots:
            raise AssertionError(f"output31: chr {c} .int has {k} rows, "
                                 f"the ledger {slots} slots")
        lines[c] = k
        if c in (sim.chrs[0], sim.chrs[-1]):
            t = np.array(path.read_text().split()[8:]).reshape(-1, 8)
            key = t[:, 0].astype(np.int64) * 2 + t[:, 2].astype(np.int64)
            st_, en = t[:, 3].astype(np.int64), t[:, 4].astype(np.int64)
            same = key[1:] == key[:-1]
            last = np.append(~same, True)
            if not (en[:-1][same] == st_[1:][same]).all() or not (
                    en[last] == sim.pops[0].rmaps[c].chr_end).all():
                raise AssertionError(f"output31: chr {c} .int chains broken")
    for x in files:
        (root / x).unlink()
    split = {k: v for k, v in out["stage_split_s"].items()
             if k.startswith("genotype_output")}
    print(f" output31: {len(files)} files, {size / 2**30:.2f} GiB "
          f"(deleted), .int rows {sum(lines.values())}; genotype output "
          f"split (s) {json.dumps(split)}")
    print(f" output31: VCF genotype formatting {fmt_s[0]:.2f} s of the "
          f"write (C codec {'loaded' if native.load() else 'absent'}); "
          f"this disk writes {disk_mb_s:.0f} MB/s (1 GiB, fsync)")
    out.update(files=len(files), bytes=size, int_rows=sum(lines.values()),
               vcf_format_s=fmt_s[0], disk_mb_s=disk_mb_s,
               native_codec=native.load() is not None)
    return out


def profile_phase(dev, work: Path, base: list) -> dict:
    """One generation of the resident segment slice under `--profile`: the
    device events (kernels, copies, sets) that start inside the
    generation's `step` span (the trace covers the whole run) by total
    time, and the device's busy share of the generation (the union of their
    intervals over the generation's host-clock time)."""
    import glob

    root = work / "profile31"
    root.mkdir()
    trace = root / "trace"
    out = slice_phase(dev, work, "profile31", SCENARIO,
                      base=_with(base, "--file_gen_info",
                                 str(_popinfo(root, SCENARIO, 1))),
                      extra=["--profile", str(trace)])
    out.pop("sim")
    files = glob.glob(str(trace / "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profile: trace files {files}")
    events = json.loads(Path(files[0]).read_text())["traceEvents"]
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == "step" and "dur" in e]
    dev_ev = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
        and lo <= e["ts"] <= hi]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev_ev)
    busy, end = 0.0, -1e300
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by = {}
    for e in dev_ev:
        k = by.setdefault(e["name"][:70], [0.0, 0])
        k[0] += e["dur"] / 1e3
        k[1] += 1
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
    gen_ms = out["s_per_gen"][0] * 1e3
    out.update(device_events=len(dev_ev), device_busy_ms=busy / 1e3,
               generation_ms=gen_ms, busy_share=busy / 1e3 / gen_ms,
               top_device_ops=[(k, round(v[0], 4), v[1]) for k, v in top])
    print(f" profile31: {len(dev_ev)} device events, busy "
          f"{busy / 1e3:.2f} ms of a {gen_ms:.2f} ms generation "
          f"({out['busy_share']:.1%})")
    for k, (ms, cnt) in top:
        print(f"   {ms:9.3f} ms  x{cnt:<5d} {k}")
    return out


def _dense_run(dev, work: Path, name: str, gens: int, base=None,
               extra=(), mat_cor=0.0, snps=None) -> dict:
    """`--backend dense` at Table 3.1's shape with a real panel (`snps` a
    chromosome, else the dense slice's) through `slice_phase`, `gens`
    generations; the resident CV matrices equal the
    planes' CVs at the end. The last generation's packed-meiosis and
    CV-gather inputs are kept under `captured`, and each generation's de
    novo mutations (a count left on the card, and the gametes drawn) under
    `captured["mutations"]`."""
    import torch

    from geneevolve_tpu_torch.dense import backend, packed
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed

    captured = {"mutations": []}
    window, cv_child = backend.meiose_window, backend.cv_child

    def window_rec(hap, fathers, mothers, plan, mu, pieces, chr_len, lo,
                   m_loc):
        # one card: one piece, the whole genome, as `meiose_packed` takes it
        captured["meiose_packed"] = (
            (hap, fathers, mothers, *plan, mu),
            dict(n_chr=m_loc // chr_len, chr_len=chr_len))
        captured["mutations"].append(
            (None if mu is None else (mu < m_loc).sum(),
             2 * fathers.shape[0]))
        return window(hap, fathers, mothers, plan, mu, pieces, chr_len, lo,
                      m_loc)

    def cv_child_rec(cv_par, parent, *rest):
        captured["gather_rows"] = (cv_par, parent)
        return cv_child(cv_par, parent, *rest)

    scenario = dict(DENSE_SCENARIO, gens=gens)
    if snps is not None:
        scenario["snps"] = snps
    extra = ["--backend", "dense", *DENSE_VARIANCES, *extra]
    if base is not None:
        (work / name).mkdir(parents=True, exist_ok=True)
        base = _with(base, "--file_gen_info",
                     str(_popinfo(work / name, scenario, gens, mat_cor)))
    backend.meiose_window, backend.cv_child = window_rec, cv_child_rec
    try:
        out = slice_phase(dev, work, name, scenario, extra, base=base)
    finally:
        backend.meiose_window, backend.cv_child = window, cv_child
    sim = out.pop("sim")
    if meiose_packed.launches != gens:
        raise AssertionError(f"{name}: {meiose_packed.launches} packed "
                             "meiosis launches, one per generation expected")
    st = sim.pops[0].state
    dp = sim.dps[0]
    for j, cols in enumerate(dp.cv_cols):
        if not torch.equal(st.cv[j], packed.cv_from_planes(st.hap, cols)):
            raise AssertionError(f"{name}: phenotype {j + 1}'s resident "
                                 "CVs differ from the planes' CVs")
    print(f" {name}: resident CVs == planes' CVs ({len(dp.cv_cols)} "
          f"phenotype(s), {st.hap.shape[0]} rows)")
    out["panel"] = dict(loci=dp.cfg.m, mut_rate=dp.cfg.mut_rate)
    out["captured"] = captured
    return out


def dense_slice(dev, work: Path) -> dict:
    """The dense slice: `_dense_run` over the scenario's own maps, 5
    generations; its captured inputs feed `dense_slice_kernels`."""
    return _dense_run(dev, work, "dense31", DENSE_SCENARIO["gens"])


def dense_odd(dev, work: Path) -> dict:
    """The dense slice over 2,000 SNPs a chromosome (`dense_odd31`): the
    backend pads each chromosome to 2,016 loci, 63 words, so kernel 4
    cuts every child row into head, body and tail and reads the B planes
    (at +1,386 words) shifted; `_dense_run`'s checks, 3 generations."""
    out = _dense_run(dev, work, "dense_odd31", DENSE_ODD_GENS,
                     snps=DENSE_ODD_SNPS)
    kw = out["captured"]["meiose_packed"][1]
    if kw["chr_len"] // 32 % 4 == 0:
        raise AssertionError(f"dense_odd31: {kw['chr_len']} loci a "
                             "chromosome, a whole number of 16-byte vectors")
    return out


def dense_mutations(dev, work: Path, dense_argv: list) -> dict:
    """The dense backend with de novo mutations that fill kernel 4's slots:
    the dense slice's panel and maps, but a mutation map of rate 1 in every
    50 kb bin, which the dense law (each panel column's bin rate over the
    bin's width) turns into ~0.9 mutations a gamete (the slice's own map:
    4.3e-4). `DENSE_MUT_GENS` generations through the CLI with
    `_dense_run`'s checks (the resident CVs equal the planes' CVs at the
    end); the mean realized count a gamete must lie in [0.5, 2]. Its last
    generation's inputs are kept for `dense_mutation_kernels`."""
    name = "densemut31"
    root = work / name
    root.mkdir(parents=True, exist_ok=True)
    rmap = Path(dense_argv[dense_argv.index("--file_recom_map") + 1])
    mmap = _mutation_map(root / "mut_flat.txt", rmap, rate=1.0)
    base = _with(dense_argv, "--file_mutation_map", str(mmap))
    out = _dense_run(dev, work, name, DENSE_MUT_GENS, base=base)
    counts = out["captured"].pop("mutations")
    total = sum(int(c) for c, _ in counts)
    gametes = sum(g for _, g in counts)
    mean = total / gametes
    out.update(mutations=total, gametes=gametes, mean_per_gamete=mean,
               mean_per_gen=[int(c) / g for c, g in counts])
    print(f" {name}: {total} de novo mutations over {gametes} gametes in "
          f"{len(counts)} generations: mean {mean:.4f} a gamete (law "
          f"{out['panel']['mut_rate']:.4f}); per generation "
          + " ".join(f"{x:.4f}" for x in out["mean_per_gen"]))
    if not 0.5 <= mean <= 2.0:
        raise AssertionError(f"{name}: mean {mean} de novo mutations a "
                             "gamete, not in [0.5, 2]")
    return out


def dense_mutation_kernels(kernels: list, captured: dict) -> None:
    """Kernel 4 on the dense mutation run's last generation's own inputs
    (every slot Km of a gamete live ~0.9 times): bit-exact to its plain
    version, and its flips change the children (the same launch without
    the mutations differs); added to the kernel's `entries`."""
    import torch

    from geneevolve_tpu_torch.ops import meiose_packed as mp

    args, kw = captured["meiose_packed"]
    hap, mu = args[0], args[7]
    r = _compare_packed(
        "meiose_packed/dense_mutations",
        lambda: mp.meiose_packed(*args, **kw),
        lambda: mp.meiose_packed_plain(*args, **kw),
        _packed_work(_packed_need(hap.shape[0], args[1:7], **kw), args[1:7],
                     mu, **kw), mp.meiose_packed)
    flipped = int((mp.meiose_packed(*args, **kw)
                   != mp.meiose_packed(*args[:7], None, **kw)).sum())
    torch.cuda.synchronize()
    if flipped == 0:
        raise AssertionError("dense mutations: the flips changed no word")
    shape = (f"{args[1].shape[0]} children of {hap.shape[0]} rows x "
             f"{hap.shape[2]} words, Km {mu.shape[2]}, "
             f"{int((mu < hap.shape[2] * 32).sum())} mutations")
    by_name = {k["name"]: k for k in kernels}
    by_name["meiose_packed"].setdefault("entries", []).append(
        dict(entry="dense_mutations", shape=shape, words_flipped=flipped,
             **r))
    print(f"   ({shape}; {flipped} words differ from the unmutated "
          "children)")


def dense_slice_kernels(kernels: list, captured: dict, entry="dense_slice",
                        names=("meiose_packed", "gather_rows")) -> None:
    """The packed meiosis and the CV row gather (`names`) against their
    plain versions on a dense run's last generation's own inputs,
    bit-exact; each result is added to its kernel's `entries` as
    `entry`."""
    from geneevolve_tpu_torch.ops import materialize as mat
    from geneevolve_tpu_torch.ops import meiose_packed as mp

    args, kw = captured["meiose_packed"]
    cv_par, parent = captured["gather_rows"]
    hap = args[0]
    cases = {
        "meiose_packed": (
            lambda: mp.meiose_packed(*args, **kw),
            lambda: mp.meiose_packed_plain(*args, **kw),
            _packed_work(_packed_need(hap.shape[0], args[1:7], **kw),
                         args[1:7], args[7], **kw), None,
            f"{args[1].shape[0]} children of {hap.shape[0]} rows x "
            f"{hap.shape[2]} words, {kw['n_chr']} chromosomes of "
            f"{kw['chr_len'] // 32} words, K {args[3].shape[2]}, "
            f"Km {0 if args[7] is None else args[7].shape[2]}"),
        "gather_rows": (
            lambda: mat.gather_rows(cv_par, parent),
            lambda: mat.gather_rows_plain(cv_par, parent),
            _gather_work(cv_par, parent, 0),
            _gather_library(cv_par, parent, 0),
            f"{parent.shape[0]} rows of {cv_par.shape[0]} x "
            f"{cv_par[0].numel() * cv_par.element_size()} bytes"),
    }
    by_name = {k["name"]: k for k in kernels}
    for name in names:
        kern, plain, work, library, shape = cases[name]
        if name == "meiose_packed":
            r = _compare_packed(f"{name}/{entry}", kern, plain, work,
                                mp.meiose_packed)
        else:
            r = _compare(f"{name}/{entry}", kern, plain, work, library)
        by_name[name].setdefault("entries", []).append(
            dict(entry=entry, shape=shape, **r))
        print(f"   ({shape})")


def dense_parity_phase(dev, work: Path, snps=256,
                       label="dense_parity") -> int:
    """`--backend dense` on `dev` vs on the CPU over a panel of `snps` a
    chromosome, the device run fed the CPU run's mating plans and draws:
    planes and CV matrices equal every generation, genotype files
    byte-identical. Returns the files compared."""
    import filecmp

    import torch

    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.dense.backend import DenseSimulation

    root = work / label
    argv = _scenario(root, n0=200, pop_size=300, gens=3, nchr=3, ncv=12,
                     snps=snps, seed=3)
    argv += ["--backend", "dense", "--out_hap", "--out_vcf", "--out_plink",
             "--seed", "7"]
    sims = {}
    for name, d in (("cpu", "cpu"), ("dev", dev)):
        (root / name).mkdir()
        cfg = parse_args(argv + ["--prefix", str(root / name / "out")])
        sims[name] = DenseSimulation(cfg, device=d, verbose=False)
    ref, sim = sims["cpu"], sims["dev"]
    mates, plans = {}, {}
    ref_mate, ref_plan = ref._mate, ref._plan
    ref._mate = lambda p, gen, ps, g: mates.setdefault(
        gen, ref_mate(p, gen, ps, g))
    ref._plan = lambda p, gen, n_pad: plans.setdefault(
        gen, ref_plan(p, gen, n_pad))
    sim._mate = lambda p, gen, ps, g: mates[gen]
    sim._plan = lambda p, gen, n_pad: tuple(
        None if x is None else x.to(dev) for x in plans[gen])
    for s in (ref, sim):
        s.init_generation0()
    for gen in range(ref.tot_gen + 1):
        if gen:
            ref.step(gen)
            sim.step(gen)
        a, b = ref.pops[0].state, sim.pops[0].state
        if a.n != b.n or not torch.equal(a.hap, b.hap.cpu()) or not all(
                torch.equal(x, y.cpu()) for x, y in zip(a.cv, b.cv)):
            raise AssertionError(f"dense parity: planes differ at gen {gen}")
    for s in (ref, sim):
        s.write_summary()
        s.save_genotypes(s.tot_gen)
        s._io_pool.shutdown(wait=True)
    names = sorted(x.name for x in (root / "cpu").iterdir())
    if names != sorted(x.name for x in (root / "dev").iterdir()):
        raise AssertionError("dense parity: different file sets")
    geno = [x for x in names
            if x.rsplit(".", 1)[-1] in ("hap", "indv", "vcf", "ped", "map")]
    if len(geno) != 3 * 5:
        raise AssertionError(f"dense parity: genotype files {geno}")
    for x in geno:
        if not filecmp.cmp(root / "cpu" / x, root / "dev" / x, shallow=False):
            raise AssertionError(f"dense parity: {x} differs")
    print(f" {label}: cuda == cpu for gens 0..{ref.tot_gen} (planes, "
          f"CV matrices; {sim.dps[0].cfg.m // 96} words a chromosome); "
          f"{len(geno)} genotype files byte-identical")
    return len(geno)


def packed_engine_phase(dev, shape=None) -> dict:
    """The packed step at the flagship shape (or `shape`, its odd twin): 1
    warm-up and 5 timed generations; the resident CV matrix equals the
    planes' CVs at the end."""
    import torch

    from geneevolve_tpu_torch.dense import packed

    cfg = packed.PackedConfig(**(shape or FLAGSHIP), couples=True)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state = packed.init_state_streamed(g, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = packed.make_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = step(state, g)  # warm-up
    torch.cuda.synchronize()
    gen_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        state = step(state, g)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    if not torch.equal(state["cv"], packed.cv_from_planes(state["hap"],
                                                          state["cv_idx"])):
        raise AssertionError("packed engine: resident CVs drifted from the "
                             "planes")
    out = dict(
        init_s=init_s, s_per_gen=gen_s,
        ind_loci_gens_per_s=cfg.n * cfg.m * len(gen_s) / sum(gen_s),
        max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
        clip=int(state["clip"]),
    )
    print(f" packed engine ({cfg.chr_len // 32} words a chromosome): s/gen "
          + " ".join(f"{x:.4f}" for x in gen_s)
          + f", {out['ind_loci_gens_per_s']:.4g} ind.loci.gens/s, peak "
          f"{out['max_memory_allocated_mb']:.0f} MiB, clip {out['clip']}, "
          f"init {init_s:.2f} s")
    return out


def byte_engine_phase(dev) -> dict:
    """The byte step (kernel `meiose_planes`) against the packed step
    (kernel `meiose_packed`), 2 generations from identically seeded
    generators: equal after unpacking."""
    import torch

    from geneevolve_tpu_torch.dense import packed, step

    pcfg = packed.PackedConfig(**{**FLAGSHIP, "n": BYTE_N})
    dcfg = pcfg.as_dense()
    g1, g2 = (torch.Generator(device=dev).manual_seed(11) for _ in range(2))
    d = step.init_state(g1, dcfg)
    p = packed.init_state(g2, pcfg)
    sd, sp = step.make_step(dcfg), packed.make_step(pcfg)
    gen_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        d = sd(d, g1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = sp(p, g2)
        torch.cuda.synchronize()
        gen_s.append((t1 - t0, time.perf_counter() - t1))
    for h, k in ((0, "hapA"), (1, "hapB")):
        for r0 in range(0, BYTE_N, 512):
            got = packed.unpack_bits(p["hap"][r0:r0 + 512, h], pcfg.m)
            if not torch.equal(got, d[k][r0:r0 + 512]):
                raise AssertionError(f"byte engine: {k} rows {r0}.. differ "
                                     "from the packed engine")
    print(" byte engine: == packed engine after 2 generations; s/gen "
          "(byte, packed) " + " ".join(f"({a:.4f}, {b:.4f})"
                                       for a, b in gen_s))
    return dict(s_per_gen_byte_packed=gen_s, clip=int(d["clip"]))


@contextlib.contextmanager
def _device_mate_recorded(plans: list):
    """Within it, each `Simulation._device_mate` call (both backends) adds
    (generation, plan, the parents' mating values, its host seconds: the
    call ends in the plan's copy back, a sync) to `plans`."""
    from geneevolve_tpu_torch.core import engine

    device_mate = engine.Simulation._device_mate

    def rec(self, p, gen, pop_size, g):
        t0 = time.perf_counter()
        plan = device_mate(self, p, gen, pop_size, g)
        dt = time.perf_counter() - t0
        plans.append((gen, plan, p.state.mv.copy(), dt))
        return plan

    engine.Simulation._device_mate = rec
    try:
        yield plans
    finally:
        engine.Simulation._device_mate = device_mate


def segment_device_mating(dev, work: Path, base: list) -> dict:
    """The segment slice under `--device_mating --avoid_inbreeding` with a
    mating correlation of `MAT_COR` in its schedule: the pairing runs on
    the card. Each generation's plan and the parents' mating values are
    kept (host arrays the engine already has; no card work inside the
    timed run) and checked after it: from generation 2 on (the founders'
    mating values are all 0) the couples' realized correlation lies within
    `MAT_COR_TOL` of the target (~6 standard errors at ~15,000 couples),
    and no vetoed couple has a child. The last generation's launches that
    read the parents are kept under `parents` (`_ParentLaunches`)."""
    name = "dm31"
    root = work / name
    root.mkdir(parents=True, exist_ok=True)
    base = _with(base, "--file_gen_info",
                 str(_popinfo(root, SCENARIO, SCENARIO["gens"], MAT_COR)))
    with _device_mate_recorded([]) as plans, \
            _ParentLaunches(SCENARIO["gens"]) as rec:
        out = slice_phase(dev, work, name, SCENARIO, base=base,
                          extra=["--device_mating", "--avoid_inbreeding"],
                          before_step=rec.before_step)
    sim = out.pop("sim")
    if len(plans) != SCENARIO["gens"]:
        raise AssertionError(f"{name}: {len(plans)} device pairings")
    if any(c["seg_need"] != c["seg_used"] for c in sim.capacity_log):
        raise AssertionError(f"capacity tripwire: {sim.capacity_log}")
    cors, vetoed = [], []
    for gen, plan, mv, _ in plans:
        inbred = plan.inbred
        vetoed.append(int(inbred.sum()))
        if inbred[plan.child_couple].any():
            raise AssertionError(f"{name}: a vetoed couple has a child "
                                 f"at gen {gen}")
        if gen >= 2:
            cors.append(plan.couple_cor_mating_value(mv))
    if not all(abs(c - MAT_COR) < MAT_COR_TOL for c in cors):
        raise AssertionError(f"{name}: couple correlations {cors}, target "
                             f"{MAT_COR} +- {MAT_COR_TOL}")
    if sum(vetoed[1:]) == 0:
        raise AssertionError(f"{name}: the veto never bit")
    out.update(parents=rec, couple_cor=cors, vetoed_couples=vetoed,
               couples=[len(p[1].father_pos) for p in plans],
               device_mate_s=[p[3] for p in plans])
    print(f" {name}: couple correlation of mating values (gens 2..) "
          + " ".join(f"{c:.4f}" for c in cors) + f" (target {MAT_COR}); "
          f"vetoed couples {vetoed}, none with a child; device mate s a "
          "generation " + " ".join(f"{p[3]:.4f}" for p in plans))
    return out


def device_mating_parity(dev) -> dict:
    """`assort_mate_device` at the slice's 30,000 individuals, on the card
    and on the CPU with the same draws (drawn on the CPU and moved), under
    the "p" law, the "f" law and MM 0.2, with the veto on sparse pedigree
    ids: the plans are identical. The card's pairing, the CPU's and the
    host numpy `assort_mate` are timed (median ms of 5, in turns; the
    card's with its draws and the plan copied back, as the engine's mate
    stage takes it)."""
    import numpy as np
    import torch

    from geneevolve_tpu_torch.core import mating
    from geneevolve_tpu_torch.parallel import mating_device as md

    n = N_CHILD
    rng = np.random.default_rng(17)
    host = dict(mv=rng.normal(size=n).astype(np.float32),
                svf=rng.uniform(0.5, 1.0, size=n).astype(np.float32),
                sex=rng.integers(1, 3, size=n),
                ped={k: rng.integers(0, n // 2, size=n)
                     for k in ("father", "ff", "fm", "mf", "mm")})
    T = torch.as_tensor
    cpu = (T(host["mv"]), T(host["svf"]), T(host["sex"]),
           {k: T(v) for k, v in host["ped"].items()})
    card = (cpu[0].to(dev), cpu[1].to(dev), cpu[2].to(dev),
            {k: v.to(dev) for k, v in cpu[3].items()})
    pop_size = n
    n_emit = pop_size + 4 * int(np.sqrt(pop_size)) + 16
    out = {}
    for law, mm in (("p", 0.0), ("f", 0.0), ("p", 0.2)):
        case = f"{law}_mm{mm:g}"
        n_children = n_emit if law == "p" else pop_size
        draws = md.draw_assort(torch.Generator().manual_seed(3), n, mm, law,
                               n_children)
        ddraws = md.MateDraws(*(None if d is None else d.to(dev)
                                for d in draws))
        args = (MAT_COR, True, pop_size, mm, law, n_children)
        want = md.pair(draws, *cpu, *args)
        got = md.pair(ddraws, *card, *args)
        for k in md.DevicePlan._fields:
            if not torch.equal(getattr(got, k).cpu(), getattr(want, k)):
                raise AssertionError(f"device mating parity ({case}): {k} "
                                     "differs")
        if not want.inbred.any():
            raise AssertionError(f"device mating parity ({case}): no veto")

        gen = torch.Generator(device=dev).manual_seed(4)

        def on_card():  # draws, pairing and the plan back on the host
            plan = md.assort_mate_device(gen, *card, *args)
            return [x.cpu() for x in plan]

        def on_host():
            return mating.assort_mate(
                np.random.default_rng(1), host["mv"], host["svf"],
                host["sex"], host["ped"], MAT_COR, mm, True, law, pop_size)

        ms = _host_turns({"card": on_card,
                          "cpu_torch": lambda: md.pair(draws, *cpu, *args),
                          "host_numpy": on_host}, reps=5)
        out[case] = dict(couples=int(want.n_couples),
                         vetoed=int(want.inbred.sum()), **ms)
        print(f" device mating parity ({case}): card == cpu, "
              f"{out[case]['couples']} couples, {out[case]['vetoed']} "
              f"vetoed; ms card {ms['card']:.3f}, cpu torch "
              f"{ms['cpu_torch']:.3f}, host numpy assort_mate "
              f"{ms['host_numpy']:.3f}")
    return out


def _host_turns(fns: dict, reps: int) -> dict:
    """Median host-clock ms of each `fns[k]()` (each ends in a sync or on
    the host), in turns, after one warm-up each."""
    import torch

    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for r in range(reps):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def dense_device_mating(dev, work: Path, dense_argv: list) -> dict:
    """The dense slice under `--device_mating` (mating correlation
    `MAT_COR`), `DENSE_DM_GENS` generations, with `_dense_run`'s checks:
    one packed meiosis a generation, the resident CVs equal to the planes'
    at the end."""
    with _device_mate_recorded([]) as plans:
        out = _dense_run(dev, work, "dense_dm31", DENSE_DM_GENS,
                         base=dense_argv, extra=["--device_mating"],
                         mat_cor=MAT_COR)
    if len(plans) != DENSE_DM_GENS:
        raise AssertionError(f"dense_dm31: {len(plans)} device pairings")
    out.pop("captured")
    del out["argv"], out["root"]
    out["device_mate_s"] = [p[3] for p in plans]
    print(" dense_dm31: device mate s a generation "
          + " ".join(f"{p[3]:.4f}" for p in plans))
    return out


def _scenario_argv(dense_argv: list, prefix: Path, *extra) -> list:
    """The dense scenario CLI's flags over a `--backend dense` scenario's
    panel, map and CVs."""
    take = {f: dense_argv[dense_argv.index(f) + 1]
            for f in ("--file_hap_name", "--file_recom_map",
                      "--file_cv_info")}
    return [x for kv in take.items() for x in kv] + [
        "--prefix", str(prefix), *extra]


def _scenario_run(dev, argv: list, name: str) -> dict:
    """`geneevolve_tpu_torch.dense.scenario.main(argv)` in this process on
    the card, its step timed a generation (host clock after a sync); the
    scenario object is kept."""
    import torch

    from geneevolve_tpu_torch.dense import scenario

    seen, gen_s, save_s = [], [], []
    evolve, make_step = scenario.evolve, scenario.make_step
    save = scenario.save_checkpoint

    def evolve_rec(sc, *a, **k):
        seen.append(sc)
        return evolve(sc, *a, **k)

    def save_rec(*a):
        t0 = time.perf_counter()
        save(*a)
        save_s.append(time.perf_counter() - t0)

    def make_step_rec(cfg, xo_cdf=None):
        step = make_step(cfg, xo_cdf=xo_cdf)

        def timed(state, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state, gen)
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            return state

        return timed

    scenario.evolve, scenario.make_step = evolve_rec, make_step_rec
    scenario.save_checkpoint = save_rec
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = scenario.main(argv, device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        scenario.evolve, scenario.make_step = evolve, make_step
        scenario.save_checkpoint = save
    if rc != 0:
        raise AssertionError(f"{name}: scenario.main returned {rc}")
    print(f" {name}: s/gen " + " ".join(f"{x:.4f}" for x in gen_s)
          + f", checkpoint saves (s) " + " ".join(f"{x:.2f}" for x in save_s)
          + f", wall {wall:.1f} s")
    return dict(sc=seen[0], s_per_gen=gen_s, checkpoint_save_s=save_s,
                wall_s=wall,
                max_memory_allocated_mb=torch.cuda.max_memory_allocated()
                / 2**20)


def scenario31(dev, work: Path, dense_argv: list) -> dict:
    """`python -m geneevolve_tpu_torch.dense.scenario` over the dense
    slice's panel, map and CVs (on panel sites): bootstrapped to 30,000,
    selection, ~1 de novo mutation a gamete, `SCENARIO_GENS` generations
    with a checkpoint every 2; the resident CVs must equal the planes'.
    The straight run's final state is kept for `scenario31_resume`."""
    import torch

    from geneevolve_tpu_torch.dense import packed

    root = work / "scenario31"
    root.mkdir(parents=True, exist_ok=True)
    flags = ["--pop_size", str(DENSE_SCENARIO["pop_size"]), "--selection",
             "--mut_rate", "1.0", "--seed", "12345",
             "--checkpoint_every", "2"]
    argv = _scenario_argv(dense_argv, root / "out", "--gens",
                          str(SCENARIO_GENS), *flags)
    t0 = time.perf_counter()
    out = _scenario_run(dev, argv, "scenario31")
    sc = out.pop("sc")
    st = sc.state
    if not torch.equal(st["cv"], packed.cv_from_planes(st["hap"],
                                                       st["cv_idx"])):
        raise AssertionError("scenario31: resident CVs differ from the "
                             "planes' CVs")
    ckpt = root / "out.ckpt.npz"
    out.update(n=sc.cfg.n, loci=sc.cfg.m, ncv=sc.cfg.ncv,
               mut_cap=sc.cfg.mut_cap, clip=int(st["clip"]),
               checkpoint_mb=ckpt.stat().st_size / 2**20,
               final=(st["hap"], st["cv"]), resume_argv=_scenario_argv(
                   dense_argv, root / "resumed", "--gens",
                   str(SCENARIO_GENS), *flags, "--resume", str(ckpt)))
    print(f" scenario31: n {sc.cfg.n} x {sc.cfg.m} loci, {sc.cfg.ncv} CVs, "
          f"resident CVs == planes' CVs; checkpoint {out['checkpoint_mb']:.1f}"
          f" MiB; peak {out['max_memory_allocated_mb']:.1f} MiB")
    return out


def scenario31_resume(dev, straight: dict) -> dict:
    """The scenario CLI resumed from the straight run's last checkpoint
    (generation `SCENARIO_GENS` - 1) to generation `SCENARIO_GENS`: its
    final planes and CVs equal the straight run's, compared on the card."""
    import torch

    out = _scenario_run(dev, straight["resume_argv"], "scenario31 resume")
    st = out.pop("sc").state
    hap, cv = straight["final"]
    if not (torch.equal(st["hap"], hap) and torch.equal(st["cv"], cv)):
        rows = int((st["hap"] != hap).flatten(1).any(1).sum())
        raise AssertionError(
            "scenario31: the resumed run's final state differs from the "
            f"straight run's: {int((st['hap'] != hap).sum())} words in "
            f"{rows} of {hap.shape[0]} rows, "
            f"{int((st['cv'] != cv).sum())} CV alleles")
    print(" scenario31 resume: final planes and CVs == the straight run's")
    return out


def scenario_parity(dev, work: Path) -> int:
    """The scenario CLI with `--out_hap` on `dev` and on the CPU over the
    dense parity scenario (200 founders, 3 chromosomes x 256 SNPs, CVs,
    selection, mutations, 3 generations), the card fed the CPU run's
    draws (parents, gamete plans, mutation loci): the `.hap`/`.indv`
    files are byte-identical. Returns the files compared."""
    import filecmp

    from geneevolve_tpu_torch.dense import packed, scenario
    from geneevolve_tpu_torch.dense import step as dense_step

    root = work / "scenario_parity"
    argv = _scenario(root, n0=200, pop_size=300, gens=3, nchr=3, ncv=12,
                     snps=256, seed=3)
    draws = {"draw_parents": [], "_sample_gamete_plan": [],
             "mutation_positions": []}
    owners = {"draw_parents": dense_step, "_sample_gamete_plan": dense_step,
              "mutation_positions": packed}
    saved = {k: getattr(m, k) for k, m in owners.items()}

    def record(k):
        def fn(*a, **kw):
            out = saved[k](*a, **kw)
            draws[k].append(out)
            return out
        return fn

    def replay(k):
        it = iter(draws[k])

        def fn(*a, **kw):
            return tuple(x.to(dev) for x in next(it))
        return fn

    for name, device, wrap in (("cpu", "cpu", record), ("dev", str(dev),
                                                         replay)):
        (root / name).mkdir()
        for k, m in owners.items():
            setattr(m, k, wrap(k))
        try:
            scenario.main(_scenario_argv(
                argv, root / name / "out", "--gens", "3", "--selection",
                "--mut_rate", "1.0", "--seed", "7", "--out_hap"),
                device=device)
        finally:
            for k, m in owners.items():
                setattr(m, k, saved[k])
    names = sorted(x.name for x in (root / "cpu").iterdir())
    if names != sorted(x.name for x in (root / "dev").iterdir()) or \
            len(names) != 6:
        raise AssertionError(f"scenario parity: files {names}")
    for x in names:
        if not filecmp.cmp(root / "cpu" / x, root / "dev" / x, shallow=False):
            raise AssertionError(f"scenario parity: {x} differs")
    print(f" scenario parity: cuda == cpu, {len(names)} .hap/.indv files "
          "byte-identical")
    return len(names)


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("no MemAvailable in /proc/meminfo")


def streamed_phase(dev) -> dict:
    """The streamed packed engine at the flagship shape without CVs (n
    16,384 x 1 Mi loci, 8 chromosomes, one a slab: 8 slabs of 512 MiB, 4
    GiB in pinned host memory), 1 warm-up and `STREAMED_TIMED` timed
    generations; h2d/d2h copy seconds a generation and ind.loci.gens/s.
    The founder slabs, the first generation's draws and its children are
    kept on the card for `streamed_check`."""
    import torch

    from geneevolve_tpu_torch.dense.packed import PackedConfig
    from geneevolve_tpu_torch.dense.streamed import StreamedPacked

    cfg = PackedConfig(**{**FLAGSHIP, "ncv": 0, "selection": False,
                          "mut_rate": 0.0})
    state_gib = cfg.n * 2 * cfg.mw * 4 / 2**30
    avail = _mem_available_gib()
    print(f" streamed: MemAvailable {avail:.1f} GiB, host state "
          f"{state_gib:.1f} GiB")
    if avail < 2 * state_gib:
        raise AssertionError(f"streamed: {avail:.1f} GiB available, "
                             f"{2 * state_gib:.1f} needed")
    t0 = time.perf_counter()
    eng = StreamedPacked.build(0, cfg, 1, device=dev)
    build_s = time.perf_counter() - t0
    if not all(h.is_pinned() for h in eng.host):
        raise AssertionError("streamed: host slabs are not pinned")
    founders = [h.to(dev) for h in eng.host]
    g = torch.Generator(device=dev).manual_seed(1)
    draws = eng.draw(g)
    t0 = time.perf_counter()
    eng.apply(*draws)  # warm-up: the first generation, kept for the check
    warm_s = time.perf_counter() - t0
    first = [h.to(dev) for h in eng.host]
    eng.h2d_s = eng.d2h_s = 0.0
    gen_s = []
    for _ in range(STREAMED_TIMED):
        t0 = time.perf_counter()
        eng.step(g)
        gen_s.append(time.perf_counter() - t0)
    gens = len(gen_s)
    out = dict(
        slabs=len(eng.host), state_gib=eng.state_bytes / 2**30,
        mem_available_gib=avail, build_s=build_s, warm_s=warm_s,
        s_per_gen=gen_s, h2d_s_per_gen=eng.h2d_s / gens,
        d2h_s_per_gen=eng.d2h_s / gens,
        ind_loci_gens_per_s=cfg.n * cfg.m * gens / sum(gen_s),
        allele_mean=eng.allele_mean(0),
        captured=(founders, draws, first, eng.cfg_slab),
    )
    print(f" streamed: {out['slabs']} slabs, {out['state_gib']:.2f} GiB "
          f"pinned, build {build_s:.2f} s, warm-up {warm_s:.3f} s; s/gen "
          + " ".join(f"{x:.4f}" for x in gen_s)
          + f"; h2d {out['h2d_s_per_gen']:.4f} s, d2h "
          f"{out['d2h_s_per_gen']:.4f} s a generation; "
          f"{out['ind_loci_gens_per_s']:.4g} ind.loci.gens/s")
    if not 0.05 < out["allele_mean"] < 0.95:
        raise AssertionError(f"streamed: allele mean {out['allele_mean']}")
    return out


def streamed_check(captured) -> int:
    """The streamed first generation against the same kernel on
    device-resident copies of the founder slabs under the same draws,
    bit-exact (comparison launches, after the counted run)."""
    import torch

    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed

    founders, (fathers, mothers, plans), first, cfg_slab = captured
    for s, (par, plan) in enumerate(zip(founders, plans)):
        want = meiose_packed(par, fathers, mothers, *plan, None,
                             n_chr=cfg_slab.n_chr, chr_len=cfg_slab.chr_len)
        if not torch.equal(want, first[s]):
            raise AssertionError(f"streamed: slab {s} differs from the "
                                 "device-resident meiosis")
    print(f" streamed: generation 1 == device-resident slabs ({len(first)} "
          "slabs, bit-exact)")
    return len(first)


# ---------------------------------------------------------------- the mesh
def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _targets(kind: str) -> list:
    """(module, attribute, call key, plain version, index of the mutation
    argument or None, indices of the output arguments it writes in place)
    of each kernel call site a mesh path reaches: the segment engine's,
    the packed steps', or the dense backend's. The call key is the
    kernel's name, then `:entry` for another entry of it."""
    from geneevolve_tpu_torch.core import engine, segments
    from geneevolve_tpu_torch.dense import packed
    from geneevolve_tpu_torch.ops import (materialize, meiose_merge,
                                          meiose_packed, meiose_planes,
                                          merge_count, paint, point_draws)
    from geneevolve_tpu_torch.parallel import mesh

    window = (mesh, "meiose_packed_window", "meiose_packed:window",
              meiose_packed.meiose_packed_window_plain, 9, (1,))
    gather = (packed, "gather_rows", "gather_rows",
              materialize.gather_rows_plain, None, ())
    if kind == "segment":
        return [
            (segments, "point_draws", "point_draws",
             point_draws.point_draws_plain, None, ()),
            (engine, "merge_count", "merge_count",
             merge_count.merge_count_plain, None, ()),
            (engine, "meiose_merge", "meiose_merge",
             meiose_merge.meiose_merge_plain, None, ()),
            (engine, "gather_rows_stacked", "gather_rows",
             materialize.gather_rows_stacked_plain, None, ()),
            (engine, "paint", "paint", paint.paint_plain, None, ()),
        ]
    if kind == "dense":
        return [window, gather]
    return [
        (mesh, "meiose_packed", "meiose_packed",
         meiose_packed.meiose_packed_plain, 7, ()),
        window,
        (mesh, "meiose_planes_window", "meiose_planes:window",
         meiose_planes.meiose_planes_window_plain, None, (2, 3)),
        gather,
    ]


@contextlib.contextmanager
def _last_calls(targets: list, calls: dict):
    """Within it, each target keeps its last call's wrapper, plain version,
    arguments (references, no copy) and output arguments in
    `calls[key]`; a packed meiosis entry without mutations (kernel 7's
    function) under `key:no_mutations`."""
    saved = []
    for mod, attr, key, plain, mu_at, outs in targets:
        fn = getattr(mod, attr)

        def rec(*a, _fn=fn, _key=key, _plain=plain, _mu=mu_at, _outs=outs,
                **k):
            name = _key
            if _mu is not None and a[_mu] is None:
                name += ":no_mutations"
            calls[name] = (_fn, _plain, a, k, _outs)
            return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, rec)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _check_calls(path: str, calls: dict) -> dict:
    """Each kernel's last call on `path` made again (comparison launches,
    after the counted run) against its plain version on the same inputs,
    bit-exact, each writing into its own copy of the outputs an entry
    writes in place; returns each call key's max_abs_err. (A segment run
    in place overwrites the planes the count, the merge and the gathers
    read: `_ParentLaunches` and `_recheck` hold those.)"""
    out = {}
    for name, (fn, plain, a, k, outs) in sorted(calls.items()):
        def fresh():
            return tuple(x.clone() if i in outs else x
                         for i, x in enumerate(a))

        out[name] = _max_abs_err(fn(*fresh(), **k), plain(*fresh(), **k))
        if out[name]:
            raise AssertionError(f"{path}: {name} differs from its plain "
                                 f"version by {out[name]}")
    print(f" {path}: {', '.join(out)} == plain on the path's last call "
          "of each")
    return out


def _expect(path: str, counts: dict, want: dict) -> None:
    bad = {k: counts[k] for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{path}: launches {bad}, {want} expected")


@contextlib.contextmanager
def _gens_timed(gen_s: list, traffic: list, seen: list, parts=None,
                before_step=None):
    """Within it, each `Simulation.step` is timed to a device sync, the
    run's `Simulation` kept in `seen` and its mesh's cumulative exchange
    record read after each generation into `traffic`. With `parts`, each
    generation's peaks (`_peaks`: before, in and after the real pass) are
    appended to it, with the peak since the last generation began under
    `held` (the allocator's peak is reset before each generation);
    `before_step(sim, gen)` runs before each generation, outside its
    timing."""
    import torch

    from geneevolve_tpu_torch.core import engine

    run, step = engine.Simulation.run, engine.Simulation.step

    def run_rec(self):
        seen.append(self)
        return run(self)

    def step_rec(self, gen):
        if before_step is not None:
            before_step(self, gen)
        if parts is not None:
            held = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _peaks(parts) if parts is not None else contextlib.nullcontext():
            step(self, gen)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
        if parts is not None:
            parts[-1]["held"] = held
        if self.mesh is not None:
            traffic.append(self.mesh.traffic.summary())

    engine.Simulation.run, engine.Simulation.step = run_rec, step_rec
    try:
        yield
    finally:
        engine.Simulation.run, engine.Simulation.step = run, step


@contextlib.contextmanager
def _exchange_peaks(rec: list):
    """Within it, each `exchange_rows` call of the engine appends (MiB
    allocated at its entry, the device's peak MiB at its end, whether the
    peak rose inside it) to `rec`: whether a fetch of the parents' rows
    (a group's in place, every chromosome's on fresh planes) or a
    migration's exchange sets a rank's peak memory."""
    import torch

    from geneevolve_tpu_torch.core import engine

    fn = engine.exchange_rows

    def rec_call(*a, **k):
        before = torch.cuda.max_memory_allocated()
        entry = torch.cuda.memory_allocated()
        out = fn(*a, **k)
        after = torch.cuda.max_memory_allocated()
        rec.append((entry / 2**20, after / 2**20, after > before))
        return out

    engine.exchange_rows = rec_call
    try:
        yield
    finally:
        engine.exchange_rows = fn


def _exchange_peak(rec: list, peak_mb: float) -> dict:
    """The highest peak reached inside an exchange, the allocation at
    that exchange's entry, and whether it is the run's peak."""
    rose = [(e, a) for e, a, up in rec if up]
    if not rose:
        return dict(exchange_peak_mb=None, exchange_entry_mb=None,
                    exchange_sets_peak=False)
    e, a = max(rose, key=lambda x: x[1])
    return dict(exchange_peak_mb=a, exchange_entry_mb=e,
                exchange_sets_peak=a >= peak_mb)


def _peak_text(out: dict) -> str:
    if out["exchange_peak_mb"] is None:
        return " (never raised inside an exchange)"
    return (f" (highest inside an exchange: {out['exchange_peak_mb']:.1f} "
            f"MiB, entered at {out['exchange_entry_mb']:.1f}; the run's "
            f"peak: {out['exchange_sets_peak']})")


def _per_gen_traffic(traffic: list) -> dict:
    """Exchange bytes and seconds of each generation, from the cumulative
    records read after each (generation 0's collectives in the first)."""
    b = [t["bytes"] for t in traffic]
    s = [t["seconds"] for t in traffic]
    return dict(exchange_bytes_per_gen=[b[0]] + [y - x for x, y in
                                                 zip(b, b[1:])],
                exchange_s_per_gen=[s[0]] + [y - x for x, y in zip(s, s[1:])],
                exchange_calls=traffic[-1]["calls"])


def _same_files(name: str, a: Path, b: Path, names: list,
                lines=None) -> int:
    """Files `names` byte-identical in `a` and `b` (with `lines`, their
    first `lines` lines)."""
    for x in names:
        fa, fb = (a / x).read_bytes(), (b / x).read_bytes()
        if lines is not None:
            fa = b"".join(fa.splitlines(True)[:lines])
            fb = b"".join(fb.splitlines(True)[:lines])
        if fa != fb:
            raise AssertionError(f"{name}: {x} differs from {a / x}")
    return len(names)


def _info_files(pops: int, gens: int) -> list:
    return [f"out.info.pop{p}.gen{g}.txt" for p in range(1, pops + 1)
            for g in range(gens + 1)]


def segment_mesh1(dev, work: Path, slice_argv: list, table31: dict) -> dict:
    """The segment slice through the CLI's `--mesh ind=1`, joined to a
    one-rank NCCL group as under torchrun (the environment names it):
    `.info`/`.summary` byte-identical to table31's, s/gen beside it. The
    last calls of the kernels that do not read the parents are kept under
    `calls`, the last generation's launches that do under `parents`
    (`_ParentLaunches`: a real pass in place overwrites them)."""
    import os

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    calls, gen_s, traffic, seen, ex = {}, [], [], [], []
    targets = [t for t in _targets("segment") if t[2] not in PARENT_KERNELS]
    with _last_calls(targets, calls), _ParentLaunches(SCENARIO["gens"]) as \
            rec, _gens_timed(gen_s, traffic, seen), _exchange_peaks(ex):
        out = slice_phase(dev, work, "segment_mesh1", SCENARIO,
                          ["--mesh", "ind=1"], base=slice_argv,
                          before_step=rec.before_step)
    sim = out.pop("sim")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if sim.mesh is None or sim.mesh.backend != backend or \
            sim.mesh.dims() != {"ind": 1, "loci": 1}:
        raise AssertionError("segment_mesh1: not on a one-rank NCCL mesh")
    n = _same_files("segment_mesh1", table31["root"], out["root"],
                    _info_files(1, SCENARIO["gens"]) + ["out.pop1.summary"])
    if any(c["seg_need"] != c["seg_used"] for c in sim.capacity_log):
        raise AssertionError(f"segment_mesh1: tripwire {sim.capacity_log}")
    out.update(_per_gen_traffic(traffic), files_identical=n, calls=calls,
               parents=rec,
               **_exchange_peak(ex, out["max_memory_allocated_mb"]))
    print(f" segment_mesh1: {n} files byte-identical to table31's; s/gen "
          + " ".join(f"{x:.3f}" for x in out["s_per_gen"]) + " (table31 "
          + " ".join(f"{x:.3f}" for x in table31["s_per_gen"]) + ")"
          + f"; peak {out['max_memory_allocated_mb']:.1f} MiB"
          + _peak_text(out))
    return out


def dense_mesh1(dev, work: Path, dense31: dict) -> dict:
    """The dense slice through the CLI's `--mesh ind=1` on the one-rank
    NCCL group `segment_mesh1` joined: `.info`/`.summary` byte-identical
    to dense31's, s/gen and peak beside it. The kernels' last calls are
    kept under `calls`."""
    calls, gen_s, traffic, seen, ex = {}, [], [], [], []
    with _last_calls(_targets("dense"), calls), \
            _gens_timed(gen_s, traffic, seen), _exchange_peaks(ex):
        out = slice_phase(dev, work, "dense_mesh1", DENSE_SCENARIO,
                          ["--backend", "dense", *DENSE_VARIANCES,
                           "--mesh", "ind=1"], base=dense31["argv"])
    sim = out.pop("sim")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if sim.mesh is None or sim.mesh.backend != backend or \
            sim.mesh.dims() != {"ind": 1, "loci": 1}:
        raise AssertionError("dense_mesh1: not on a one-rank NCCL mesh")
    n = _same_files("dense_mesh1", dense31["root"], out["root"],
                    _info_files(1, DENSE_SCENARIO["gens"])
                    + ["out.pop1.summary"])
    out.update(_per_gen_traffic(traffic), files_identical=n, calls=calls,
               **_exchange_peak(ex, out["max_memory_allocated_mb"]))
    print(f" dense_mesh1: {n} files byte-identical to dense31's; s/gen "
          + " ".join(f"{x:.3f}" for x in out["s_per_gen"]) + " (dense31 "
          + " ".join(f"{x:.3f}" for x in dense31["s_per_gen"]) + ")"
          + f"; peak {out['max_memory_allocated_mb']:.1f} MiB (dense31 "
          f"{dense31['max_memory_allocated_mb']:.1f})" + _peak_text(out))
    return out


def _byte_flagship():
    from geneevolve_tpu_torch.dense.packed import PackedConfig

    return PackedConfig(**{**FLAGSHIP, "n": BYTE_N}).as_dense()


def packed_mesh1_inputs(dev) -> dict:
    """The flagship's founders and the one-rank packed step's generation
    from them; the byte step's founders (n 4,096 x 1 Mi loci) and its
    one-rank generation: the references of `packed_mesh1`, made before
    its counted run."""
    import torch

    from geneevolve_tpu_torch.dense import packed, step

    cfg = packed.PackedConfig(**FLAGSHIP)
    state = packed.init_state_streamed(
        torch.Generator(device=dev).manual_seed(0), cfg)
    ref = packed.make_step(cfg)(state, torch.Generator(device=dev)
                                .manual_seed(5))
    dcfg = _byte_flagship()
    dstate = step.init_state(torch.Generator(device=dev).manual_seed(11),
                             dcfg)
    dref = step.make_step(dcfg)(dstate, torch.Generator(device=dev)
                                .manual_seed(5))
    torch.cuda.synchronize()
    return dict(cfg=cfg, state=state, ref=ref, dcfg=dcfg, dstate=dstate,
                dref=dref)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _overflows(seen: list):
    """Within it, every `routed_fetch` overflow count lands in `seen`."""
    from geneevolve_tpu_torch.parallel import mesh

    fetch = mesh.routed_fetch

    def rec(*a, **k):
        out = fetch(*a, **k)
        seen.append(out[1])
        return out

    mesh.routed_fetch = rec
    try:
        yield
    finally:
        mesh.routed_fetch = fetch


def _packed_steps(mesh, cfg, state, tag: str, ref=None) -> dict:
    """`make_sharded_step` (against `ref`, the one-rank generation), then
    one generation each of `make_deme_step` with ring migration and
    without mutations (the packed meiosis's no-mutation entry, kernel 7's
    function) and `make_routed_step`, on this rank's shard of `state`;
    seconds and ind.loci.gens/s of each, exchange bytes, routed
    overflows."""
    import dataclasses

    import torch

    from geneevolve_tpu_torch.parallel import mesh as pm

    shard = pm.shard_state(state, mesh)
    out, ov = {}, []
    for kind, make in (("sharded", pm.make_sharded_step),
                       ("deme", lambda c, m: pm.make_deme_step(
                           dataclasses.replace(c, mut_rate=0.0), m,
                           mig_rate=0.125)),
                       ("routed", pm.make_routed_step)):
        mesh.traffic.reset()
        step = make(cfg, mesh)
        with _overflows(ov):
            got, s = _timed(lambda: step(
                shard, torch.Generator(device=mesh.device).manual_seed(5)))
        out[kind] = dict(s=s, ind_loci_gens_per_s=cfg.n * cfg.m / s,
                         **mesh.traffic.summary())
        rows = cfg.n // mesh.size("ind")
        if got["hap"].shape[0] != rows or got["cv"].shape[0] != rows:
            raise AssertionError(f"{tag} {kind}: {got['hap'].shape[0]} rows "
                                 f"on a rank, {rows} expected")
        if kind == "sharded" and ref is not None:
            want = pm.shard_state(ref, mesh)
            for k in ("hap", "cv", "clip"):
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"{tag}: sharded step's {k} "
                                         "differs from the one-rank step's")
        del got
    out["routed_overflow"] = int(sum(int(x) for x in ov))
    if out["routed_overflow"]:
        raise AssertionError(f"{tag}: routed overflow {ov}")
    print(f" {tag}: " + ", ".join(
        f"{k} {v['s'] * 1e3:.2f} ms ({v['ind_loci_gens_per_s']:.4g} "
        f"ind.loci.gens/s, {v['bytes'] / 2**20:.1f} MiB exchanged)"
        for k, v in out.items() if isinstance(v, dict))
        + "; sharded == one rank, routed overflow 0")
    return out


def packed_mesh1(dev, inp: dict) -> dict:
    """On the one-rank NCCL group: the flagship through `make_sharded_step`
    bit-identical to `dense.packed.make_step`, one generation each of the
    deme and routed steps, and the byte step (n 4,096) through
    `make_sharded_step(DenseConfig)` bit-identical to
    `dense.step.make_step`. The kernels' last calls are kept under
    `calls`."""
    import torch

    from geneevolve_tpu_torch.parallel import mesh as pm

    calls = {}
    with _last_calls(_targets("packed"), calls):
        mesh = pm.make_mesh((1, 1), dev)
        out = _packed_steps(mesh, inp["cfg"], inp.pop("state"),
                            "packed_mesh1", inp.pop("ref"))
        torch.cuda.empty_cache()
        step = pm.make_sharded_step(inp["dcfg"], mesh)
        got, s = _timed(lambda: step(pm.shard_state(inp["dstate"], mesh),
                                     torch.Generator(device=dev)
                                     .manual_seed(5)))
        for k in ("hapA", "hapB", "clip"):
            if not torch.equal(got[k], inp["dref"][k]):
                raise AssertionError(f"packed_mesh1: byte step's {k} "
                                     "differs from the one-rank step's")
        out["byte_sharded_s"] = s
    print(f" packed_mesh1: byte sharded step {s * 1e3:.2f} ms == one rank")
    out["calls"] = calls
    return out


def _mesh_cli(dev, root: Path, argv: list, shape=(2, 1),
              segment=False) -> dict:
    """`cli.main` with `--mesh` of `shape` in a rank of the two-rank group
    (it joins the group); s/gen, exchange per generation, the block of
    the planes a rank holds and the tripwire. `segment`: also each
    generation's peaks before, in and after the real pass, the run's peak
    (`run_peak_mb`), the reckoned need (`Simulation.mem_plan`), which
    generations ran in place, and the last generation's last launches of
    the stacked kernels under `launches_rec` (`_MeshLaunches`)."""
    import torch

    from geneevolve_tpu_torch import cli

    root.mkdir(parents=True, exist_ok=True)
    gen_s, traffic, seen, ex = [], [], [], []
    parts = [] if segment else None
    rec = _MeshLaunches() if segment else contextlib.nullcontext()
    with rec, _gens_timed(gen_s, traffic, seen, parts,
                          rec.before_step if segment else None), \
            _exchange_peaks(ex):
        rc = cli.main(argv + ["--seed", "12345", "--prefix",
                              str(root / "out"), "--stage_sync", "--mesh",
                              f"ind={shape[0]},loci={shape[1]}"],
                      device=dev.type)
    if rc != 0:
        raise AssertionError(f"{root.name}: cli.main returned {rc}")
    sim = seen[0]
    if sim.mesh.backend != "gloo" or sim.mesh.dims() != {
            "ind": shape[0], "loci": shape[1]}:
        raise AssertionError(f"{root.name}: not on a {shape} gloo mesh")
    if any(c["seg_need"] != c["seg_used"] for c in sim.capacity_log):
        raise AssertionError(f"{root.name}: tripwire {sim.capacity_log}")
    rows = [sim._block_rows(p.state) for p in sim.pops]
    split = {k: round(v, 4) for k, v in sim.timer.totals.items()}
    out = dict(s_per_gen=gen_s, block_rows=rows, stage_split_s=split,
               exchange_calls_rec=ex, **_per_gen_traffic(traffic))
    if hasattr(sim.pops[0].state, "hap"):
        out["block_shape"] = list(sim.pops[0].state.hap.shape)
    if segment:
        mib = 2**20
        out.update(
            peaks_per_gen_mb=[{k: v / mib for k, v in x.items()}
                              for x in parts],
            run_peak_mb=max(torch.cuda.max_memory_allocated(),
                            *(max(x.values()) for x in parts)) / mib,
            need_mb=sim.mem_plan.need / mib,
            in_place=[c["in_place"] for c in sim.capacity_log],
            per_group=[c["per_group"] for c in sim.capacity_log],
            idle_counts=rec.idle, launches_rec=rec)
    return out


def _in_place_within_need(name: str, o: dict) -> None:
    """Every generation of a one-population segment rank ran in place, and
    its peak did not pass its reckoned need."""
    if not (all(o["in_place"]) and o["max_memory_allocated_mb"]
            <= o["need_mb"]):
        raise AssertionError(
            f"{name}: in place {o['in_place']}, peak "
            f"{o['max_memory_allocated_mb']:.1f} MiB against the reckoned "
            f"{o['need_mb']:.1f}")


def _mesh_want(want: dict, out: dict) -> dict:
    """A segment rank's launches expected: `want`, less the counts it made
    without a launch (`_MeshLaunches.idle`)."""
    return dict(want, merge_count=want["merge_count"]
                - out.get("idle_counts", 0))


class _MeshLaunches:
    """Records, on a rank of a segment run under a mesh, the last launch
    of each stacked segment kernel in the last generation's last
    population, so that `_check_mesh_launches` can make it again after the
    run on its own inputs, without holding a plane or a plan inside the
    timed run: for the draws, the arguments of the last `_plan` call and
    a checksum of each stacked draw of uniforms it made (a reduction on the
    card, no sync; the plan is drawn again after the run); for the count, its
    chromosome range, the address of the parents' block it read and the
    `_owned_gametes` it counted (small index tensors; its operands rebuilt
    after the run by the engine's `_count_columns`); for the merge and the
    gathers and the gamete inheritance, references to the last group's
    arguments (that group's fetched parent rows, which nothing
    overwrites). `idle` counts the
    probe's counts the rank made without a launch, holding no parent of
    any child (generation 1's founders lie on rank 0). `before_step` copies
    the parents' planes to the host before the last generation on rank 0,
    outside its timing: the count read this rank's block of them, which a
    real pass in place overwrites."""

    def __init__(self):
        self.on = self.last_group = False
        self.sim, self.copy, self.calls = None, {}, {}
        self.plan = self.count = self.owned = None
        self.draws: list = []
        self.idle = 0

    def before_step(self, sim, gen):
        if gen == sim.tot_gen:
            self.sim = sim
            if sim.is_root:  # rank 0 checks the launches
                self.copy = _parents_copy(sim)

    def __enter__(self):
        from geneevolve_tpu_torch.core import engine, segments
        from geneevolve_tpu_torch.ops import gamete_inherit as gi
        from geneevolve_tpu_torch.ops import materialize as mat
        from geneevolve_tpu_torch.ops import meiose_merge as mm

        sim_cls = engine.Simulation
        self.saved = [(engine, k, getattr(engine, k)) for k in (
            "merge_count", "meiose_merge", "gather_rows_stacked",
            "gamete_inherit")] + [
            (segments, "point_draws", segments.point_draws)] + [
            (sim_cls, k, getattr(sim_cls, k)) for k in (
                "_reproduce", "_reproduce_group", "_plan",
                "_owned_gametes", "_probe_counts")]
        fns = {k: fn for _, k, fn in self.saved}

        def reproduce(sim, p, gen, plan):
            self.on = gen == sim.tot_gen and p.index == sim.n_pop - 1
            try:
                return fns["_reproduce"](sim, p, gen, plan)
            finally:
                self.on = False

        def group(sim, st, parents, draws, c0=0):
            self.last_group = self.on and \
                c0 + st.seg_st.shape[0] == len(sim.chrs)
            try:
                return fns["_reproduce_group"](sim, st, parents, draws, c0)
            finally:
                self.last_group = False

        def plan(sim, p, gen, n_pad, c0=0, c1=None):
            if self.on:
                self.plan, self.draws = (p, gen, n_pad, c0, c1), []
            return fns["_plan"](sim, p, gen, n_pad, c0, c1)

        def owned(sim, parents, rows):
            out = fns["_owned_gametes"](sim, parents, rows)
            if self.on:
                self.owned = (parents, out)
            return out

        def probe(sim, seg_st, mut, parents, plan, owned=None):
            self.idle += owned == ()
            return fns["_probe_counts"](sim, seg_st, mut, parents, plan,
                                        owned)

        def draws(*a):
            if self.on:
                self.draws.append(_checksum(a[1]))
            return fns["point_draws"](*a)

        def count(seg_st, *a):
            if self.on:
                c0 = seg_st.storage_offset() // seg_st.stride(0)
                self.count = (_desc(seg_st), self.plan[:3], c0,
                              c0 + seg_st.shape[0])
            return fns["merge_count"](seg_st, *a)

        def kept(key, fn, plain):
            def rec(*a, **k):
                if self.last_group:
                    self.calls[key] = (fn, plain, a, k, ())
                return fn(*a, **k)
            return rec

        engine.merge_count = count
        engine.meiose_merge = kept("meiose_merge", fns["meiose_merge"],
                                   mm.meiose_merge_plain)
        engine.gather_rows_stacked = kept(
            "gather_rows", fns["gather_rows_stacked"],
            mat.gather_rows_stacked_plain)

        def inherit(*a):
            if self.last_group:  # the outputs it wrote, on fresh planes
                self.calls["gamete_inherit"] = (
                    _inherit_outputs(gi.gamete_inherit),
                    _inherit_outputs(gi.gamete_inherit_plain), a, {}, ())
            return fns["gamete_inherit"](*a)

        engine.gamete_inherit = inherit
        segments.point_draws = draws
        sim_cls._reproduce, sim_cls._reproduce_group = reproduce, group
        sim_cls._plan, sim_cls._owned_gametes = plan, owned
        sim_cls._probe_counts = probe
        return self

    def __exit__(self, *exc):
        for mod, k, fn in self.saved:
            setattr(mod, k, fn)
        self.on = self.last_group = False
        self.saved = None  # no cycle through the hooks


def _check_mesh_launches(path: str, rec: _MeshLaunches) -> dict:
    """The launches `rec` recorded, made again (comparison launches, after
    the counted run) against their plain versions, bit-exact: the draws of
    the last `_plan` call, drawn again and held to the run's checksums;
    the count on the host copy of the parents' block it read, back on the
    card, with the columns `_count_columns` builds from the plan drawn
    again; the last group's merge, last gather and last gamete inheritance
    on their own arguments.
    Returns each kernel's max_abs_err."""
    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.ops import merge_count as mc
    from geneevolve_tpu_torch.ops import point_draws as pd

    sim = rec.sim
    if sim is None or rec.count is None or rec.owned is None or \
            set(rec.calls) != {"meiose_merge", "gather_rows",
                               "gamete_inherit"}:
        raise AssertionError(f"{path}: the last generation's launches were "
                             "not recorded")
    seen, draws = [], segments.point_draws
    segments.point_draws = lambda *a: seen.append(a) or draws(*a)
    try:
        sim._plan(*rec.plan)
    finally:
        segments.point_draws = draws
    if [int(_checksum(a[1])) for a in seen] != [int(x) for x in rec.draws]:
        raise AssertionError(f"{path}: the plan drawn again differs from "
                             "the run's")
    a = seen[-1]
    del seen
    out = {"point_draws": _max_abs_err(pd.point_draws(*a),
                                       pd.point_draws_plain(*a))}
    (ptr, shape, dtype), (p, gen, n_pad), c0, c1 = rec.count
    for (pop, key), (start, host) in rec.copy.items():
        off = ptr - start
        if pop == p.index and key == "seg_st" and \
                0 <= off < host.numel() * host.element_size():
            break
    else:
        raise AssertionError(f"{path}: the last count read no plane of the "
                             "copy taken before the last generation")
    seg = host[c0:c1]
    if off != c0 * seg[0].numel() * seg.element_size() or tuple(
            seg.shape) != shape or seg.dtype != dtype:
        raise AssertionError(f"{path}: the last count reads its plane in a "
                             "way the copy misses")
    seg = seg.to(sim.device)
    parents, owned = rec.owned
    args = (seg,) + sim._count_columns(
        parents, sim._plan(p, gen, n_pad, c0, c1), owned)[:4]
    out["merge_count"] = _max_abs_err(mc.merge_count(*args),
                                      mc.merge_count_plain(*args))
    out.update(_check_calls(path, rec.calls))
    bad = {k: v for k, v in out.items() if v}
    if bad:
        raise AssertionError(f"{path}: {bad} differ from their plain "
                             "versions")
    print(f" {path}: point_draws, merge_count (chromosomes {c0}-{c1 - 1}, the "
          f"parents' block as it was read) == plain on the last "
          "generation's last launches")
    return out


def _dense_mesh2(dev, work: Path, argv: list) -> dict:
    """The dense slice's first generations through the CLI at `--mesh
    ind=2` and at `ind=1,loci=2` in the two-rank group."""
    out, ex = {}, []
    for shape in ((2, 1), (1, 2)):
        tag = f"{shape[0]}x{shape[1]}"
        out[tag] = _mesh_cli(dev, work / f"dense_mesh2_{tag}", argv, shape)
        ex += out[tag].pop("exchange_calls_rec")
    out["exchange_calls_rec"] = ex
    return out


def _packed_mesh2(dev, cfg, state, ref, split) -> dict:
    """The three steps at n 4,096 x 1 Mi loci on the two-rank group, at
    (ind, loci) = (2, 1) and (1, 2), the sharded step against `ref`; then
    the sharded step at (1, 2) over `split` = (cfg, state, one-rank
    generation) of 7 chromosomes, a rank's window holding 3.5 of them."""
    import torch

    from geneevolve_tpu_torch.parallel import mesh as pm

    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = pm.make_mesh(shape, dev)
        out[f"{shape[0]}x{shape[1]}"] = _packed_steps(
            mesh, cfg, state, f"packed_mesh2 {shape}", ref)
    scfg, sstate, sref = split
    mesh = pm.make_mesh((1, 2), dev)
    lo = mesh.coord("loci") * scfg.m // 2
    pieces = pm.loci_pieces(scfg.n_chr, scfg.chr_len, lo, scfg.m // 2)
    step = pm.make_sharded_step(scfg, mesh)
    got, s = _timed(lambda: step(pm.shard_state(sstate, mesh),
                                 torch.Generator(device=dev).manual_seed(5)))
    want = pm.shard_state(sref, mesh)
    for k in ("hap", "cv", "clip"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"packed_mesh2 split: the sharded step's {k}"
                                 " differs from the one-rank step's")
    out["split_1x2"] = dict(
        s=s, pieces=[dict(c0=p.c0, n_chr=p.n_chr, off=p.off,
                          length=p.length, lo=p.lo) for p in pieces])
    print(f" packed_mesh2 split (1, 2): 7 chromosomes of {scfg.chr_len} "
          f"loci, {len(pieces)} pieces a rank, {s * 1e3:.2f} ms == one rank")
    return out


def _mesh_phase(rank: int, res: dict, path: str, kind: str, fn) -> None:
    """`fn()` on a rank of the two-rank group, as the path `path`: the
    launch counts set to 0 just before it and read just after, the peak
    (its `run_peak_mb` where `_mesh_cli` read it generation by
    generation), and on rank 0 each kernel's last call of the path held
    against its plain version after it (the segment paths' stacked
    kernels: `_MeshLaunches`); kept in `res[path]`."""
    import torch

    wrappers, windows = _wrappers(), _windows()
    calls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in (*wrappers.values(), *windows.values()):
        w.launches = 0
    t0 = time.perf_counter()
    targets = [t for t in _targets(kind) if kind != "segment"
               or t[2] not in SEGMENT]  # `_MeshLaunches` holds those
    with _last_calls(targets, calls):
        out = fn()
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    out["window_launches"] = {k: w.launches for k, w in windows.items()}
    out["max_memory_allocated_mb"] = max(
        torch.cuda.max_memory_allocated() / 2**20,
        out.pop("run_peak_mb", 0.0))
    if "exchange_calls_rec" in out:
        out.update(_exchange_peak(out.pop("exchange_calls_rec"),
                                  out["max_memory_allocated_mb"]))
    rec = out.pop("launches_rec", None)
    if rank == 0:
        out["plain_checks"] = _check_calls(path, calls) if calls else {}
        if rec is not None:
            out["plain_checks"].update(_check_mesh_launches(path, rec))
    del rec, calls
    res[path] = out
    torch.cuda.empty_cache()


def _rank_device(rank: int, device: str):
    """The rank's device, the kernels built (rank 0 prints the logs)."""
    import io

    import torch

    from geneevolve_tpu_torch.ops import _build

    if rank:
        sys.stdout = io.StringIO()
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.lib()
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh2_rank(rank: int, device: str, work: str, seg_argv: list,
                multipop_argv: list, dense_argv: list, big_argv: list) -> dict:
    """One rank of the two ranks that share the card over gloo: the
    segment slice (`segment_mesh2`), two populations (`multipop_mesh2`),
    Table 3.1's top row (`table31_300k_mesh2`), the dense slice
    (`dense_mesh2`) and the packed steps (`packed_mesh2`), each a
    `_mesh_phase`."""
    import torch

    from geneevolve_tpu_torch.dense import packed

    dev = _rank_device(rank, device)
    work = Path(work)
    res = {}
    for path, argv in (("segment_mesh2", seg_argv),
                       ("multipop_mesh2", multipop_argv),
                       ("table31_300k_mesh2", big_argv)):
        _mesh_phase(rank, res, path, "segment",
                    lambda: _mesh_cli(dev, work / path, argv, segment=True))
    _mesh_phase(rank, res, "dense_mesh2", "dense",
                lambda: _dense_mesh2(dev, work, dense_argv))
    # the one-rank references, made before the counted run
    cfg = packed.PackedConfig(**{**FLAGSHIP, "n": MESH_N})
    state = packed.init_state_streamed(
        torch.Generator(device=dev).manual_seed(0), cfg)
    ref = packed.make_step(cfg)(state,
                                torch.Generator(device=dev).manual_seed(5))
    scfg = packed.PackedConfig(**SPLIT)
    sstate = packed.init_state_streamed(
        torch.Generator(device=dev).manual_seed(1), scfg)
    sref = packed.make_step(scfg)(sstate,
                                  torch.Generator(device=dev).manual_seed(5))
    _mesh_phase(rank, res, "packed_mesh2", "packed",
                lambda: _packed_mesh2(dev, cfg, state, ref,
                                      (scfg, sstate, sref)))
    return res


def mesh_phases(dev, work: Path, wrappers: dict, launches: dict,
                slice_out: dict, multipop_argv: list, dense31: dict,
                big: dict) -> dict:
    """The mesh paths: `segment_mesh1`, `packed_mesh1` and `dense_mesh1`
    on a one-rank NCCL group in this process; then two ranks sharing the
    card over gloo (`segment_mesh2`, `multipop_mesh2`, `table31_300k_mesh2`
    over `big`, `table31_300k`'s files, `dense_mesh2`, `packed_mesh2`)
    against the unsharded runs' files. The segment runs go in place on
    both ranks: each rank's peak (before, in and after each real pass)
    must not pass its reckoned need."""
    import os

    import torch
    import torch.distributed as dist

    from geneevolve_tpu_torch.parallel import launch

    t_all = time.perf_counter()
    res = {}
    res["segment_mesh1"] = counted(
        "segment_mesh1", wrappers,
        lambda: segment_mesh1(dev, work, slice_out["argv"], slice_out),
        launches)
    _expect("segment_mesh1", launches["segment_mesh1"],
            {k: v * SCENARIO["gens"] for k, v in SEGMENT_PER_GEN.items()})
    res["segment_mesh1"]["plain_checks"] = _check_calls(
        "segment_mesh1", res["segment_mesh1"].pop("calls"))
    res["segment_mesh1"]["parent_launches_checked"] = _recheck(
        "segment_mesh1", res["segment_mesh1"].pop("parents"),
        children=True)["checked"]
    for k in ("argv", "root", "sim"):
        res["segment_mesh1"].pop(k, None)
    torch.cuda.empty_cache()
    inp = packed_mesh1_inputs(dev)
    res["packed_mesh1"] = counted("packed_mesh1", wrappers,
                                  lambda: packed_mesh1(dev, inp), launches)
    _expect("packed_mesh1", launches["packed_mesh1"],
            {"meiose_packed": 3, "gather_rows": 6, "meiose_planes": 1})
    del inp
    res["packed_mesh1"]["plain_checks"] = _check_calls(
        "packed_mesh1", res["packed_mesh1"].pop("calls"))
    torch.cuda.empty_cache()
    res["dense_mesh1"] = counted(
        "dense_mesh1", wrappers, lambda: dense_mesh1(dev, work, dense31),
        launches)
    _expect("dense_mesh1", launches["dense_mesh1"],
            {k: v * DENSE_SCENARIO["gens"] for k, v in DENSE_PER_GEN.items()})
    _expect("dense_mesh1 (window entry)", WINDOW_LAUNCHES["dense_mesh1"],
            {"meiose_packed": DENSE_SCENARIO["gens"]})
    res["dense_mesh1"]["plain_checks"] = _check_calls(
        "dense_mesh1", res["dense_mesh1"].pop("calls"))
    for k in ("argv", "root", "gen0_launches"):
        res["dense_mesh1"].pop(k, None)
    dist.destroy_process_group()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        os.environ.pop(k, None)
    torch.cuda.empty_cache()
    # the unsharded two-population run without --gamma (under a mesh the
    # gamma moments are f32 device sums, as in the JAX engine)
    ref = slice_phase(dev, work, "multipop_ref",
                      dict(SCENARIO, gens=MESH_GENS), base=multipop_argv)
    ref.pop("sim")
    torch.cuda.empty_cache()
    seg_argv = _with(slice_out["argv"], "--file_gen_info", str(_popinfo(
        work, SCENARIO, MESH_GENS)))
    (work / "dense_mesh").mkdir(exist_ok=True)
    dense_argv = _with(dense31["argv"], "--file_gen_info", str(_popinfo(
        work / "dense_mesh", DENSE_SCENARIO, MESH_GENS))) + [
        "--backend", "dense", *DENSE_VARIANCES]
    t0 = time.perf_counter()
    ranks = launch.launch(_mesh2_rank, 2, (dev.type, str(work), seg_argv,
                                            multipop_argv, dense_argv,
                                            big["argv"]),
                          device=dev.type, backend="gloo",
                          timeout_s=MESH_TIMEOUT_S + BIG_MESH_TIMEOUT_S,
                          pg_timeout_s=300)
    spawn_s = time.perf_counter() - t0
    log = [dict(in_place=a, per_group=b) for a, b in zip(
        ranks[0]["multipop_mesh2"]["in_place"],
        ranks[0]["multipop_mesh2"]["per_group"])]
    want = {
        # two 'ind' ranks, in place: as one card
        "segment_mesh2": {k: v * MESH_GENS for k, v in
                          SEGMENT_PER_GEN.items()},
        "table31_300k_mesh2": {k: v * BIOBANK_GENS for k, v in
                               PER_GROUP_PER_GEN.items()},
        # in place where a generation's children fit the rows the
        # migration left
        "multipop_mesh2": dict(
            _launches_from_log(log, True),
            paint=2 * len(log) + GEN0_LAUNCHES["segment_multipop"]["paint"]),
        # 2 layouts x 3 generations, 1 window launch each (whole
        # chromosomes at both layouts: 22 split as 11 + 11)
        "dense_mesh2": {k: 2 * v * MESH_GENS
                        for k, v in DENSE_PER_GEN.items()},
        # 2 layouts x 3 steps, then the split case's 2 window launches and
        # 2 CV gathers a rank
        "packed_mesh2": {"meiose_packed": 8, "gather_rows": 14},
    }
    want_window = {"dense_mesh2": {"meiose_packed": 2 * MESH_GENS},
                   "packed_mesh2": {"meiose_packed": 4}}
    paths = ("segment_mesh2", "multipop_mesh2", "table31_300k_mesh2",
             "dense_mesh2", "packed_mesh2")
    for path in paths:
        res[path] = {f"rank{r}": out[path] for r, out in enumerate(ranks)}

    def gen_line(path, r, o):
        print(f" {path} rank {r}: s/gen "
              + " ".join(f"{x:.3f}" for x in o["s_per_gen"])
              + "; exchange a generation "
              + " ".join(f"{b / 2**20:.1f} MiB/{s:.3f} s" for b, s in
                         zip(o["exchange_bytes_per_gen"][1:],
                             o["exchange_s_per_gen"][1:])))

    for path in ("segment_mesh2", "multipop_mesh2", "table31_300k_mesh2",
                 "dense_mesh2"):
        for r in range(2):
            o = res[path][f"rank{r}"]
            if path == "dense_mesh2":
                for tag in ("2x1", "1x2"):
                    gen_line(f"{path} {tag}", r, o[tag])
            else:
                gen_line(path, r, o)
            print(f" {path} rank {r}: peak {o['max_memory_allocated_mb']:.1f}"
                  " MiB" + _peak_text(o))
            if path == "dense_mesh2":
                continue
            print(f" {path} rank {r}: in place {o['in_place']}; a "
                  "generation's peak (probe / real pass / the rest) "
                  + ", ".join(f"{x['probe']:.0f}/{x['real']:.0f}/"
                              f"{x['rest']:.0f}"
                              for x in o["peaks_per_gen_mb"])
                  + f" MiB; reckoned need {o['need_mb']:.1f} MiB")
    for path in paths:
        for r, out in enumerate(ranks):
            counts = out[path]["launches"]
            idle = [k for k in PATHS[path] if counts[k] <= 0]
            if idle:
                raise AssertionError(f"{path} rank {r}: kernels never "
                                     f"launched: {idle}")
            _expect(f"{path} rank {r}", counts,
                    _mesh_want(want[path], out[path])
                    if "merge_count" in want[path] else want[path])
            _expect(f"{path} rank {r} (window entry)",
                    out[path]["window_launches"], want_window.get(path, {}))
        launches[path] = ranks[0][path]["launches"]
        WINDOW_LAUNCHES[path] = ranks[0][path]["window_launches"]
        print(f" {path}: launches a rank {json.dumps(launches[path])}")
    for path in ("segment_mesh2", "table31_300k_mesh2"):
        for r in range(2):
            _in_place_within_need(f"{path} rank {r}", res[path][f"rank{r}"])
    n = _same_files("segment_mesh2", slice_out["root"],
                    work / "segment_mesh2", _info_files(1, MESH_GENS))
    n += _same_files("segment_mesh2", slice_out["root"],
                     work / "segment_mesh2", ["out.pop1.summary"],
                     lines=MESH_GENS + 2)
    res["segment_mesh2"]["files_identical"] = n
    res["table31_300k_mesh2"]["files_identical"] = _same_files(
        "table31_300k_mesh2", big["root"], work / "table31_300k_mesh2",
        _info_files(1, BIOBANK_GENS) + ["out.pop1.summary"])
    n = _same_files("multipop_mesh2", ref["root"], work / "multipop_mesh2",
                    _info_files(2, MESH_GENS)
                    + ["out.pop1.summary", "out.pop2.summary"])
    res["multipop_mesh2"]["files_identical"] = n
    res["multipop_ref_s_per_gen"] = ref["s_per_gen"]
    n = 0
    for tag in ("2x1", "1x2"):
        d = work / f"dense_mesh2_{tag}"
        n += _same_files("dense_mesh2", dense31["root"], d,
                         _info_files(1, MESH_GENS))
        n += _same_files("dense_mesh2", dense31["root"], d,
                         ["out.pop1.summary"], lines=MESH_GENS + 2)
    res["dense_mesh2"]["files_identical"] = n

    peaks = [res["segment_mesh2"][f"rank{r}"]["max_memory_allocated_mb"]
             for r in range(2)]
    print(" segment_mesh2: peak a rank " + " / ".join(f"{x:.1f}"
                                                      for x in peaks)
          + f" MiB in place (the whole fetch on fresh planes: "
          f"{SEGMENT_MESH2_FRESH_MB} MiB); one card in place (table31) "
          f"{slice_out['max_memory_allocated_mb']:.1f} MiB")
    if not max(peaks) < slice_out["max_memory_allocated_mb"]:
        raise AssertionError("segment_mesh2: a rank's peak is not below one "
                             "card's")
    big_peaks = [res["table31_300k_mesh2"][f"rank{r}"][
        "max_memory_allocated_mb"] for r in range(2)]
    print(" table31_300k_mesh2: .info/.summary byte-identical to "
          "table31_300k's; peak a rank " + " / ".join(
              f"{x:.1f}" for x in big_peaks) + " MiB against one card's "
          f"{big['max_memory_allocated_mb']:.1f}; s/gen "
          + " ".join(f"{x:.3f}" for x in res["table31_300k_mesh2"]["rank0"][
              "s_per_gen"])
          + " against " + " ".join(f"{x:.3f}" for x in big["s_per_gen"]))
    print(f" dense_mesh2: {n} files byte-identical to dense31's first "
          f"{MESH_GENS} generations at (2, 1) and (1, 2)")
    print(f" segment_mesh2: files byte-identical to table31's first "
          f"{MESH_GENS} generations (table31 s/gen "
          + " ".join(f"{x:.3f}" for x in slice_out["s_per_gen"]) + ")")
    print(" multipop_mesh2: files byte-identical to the unsharded run's "
          "(s/gen " + " ".join(f"{x:.3f}" for x in ref["s_per_gen"]) + ")")
    res["spawn_s"] = spawn_s
    res["wall_s"] = time.perf_counter() - t_all
    print(f" mesh phases: {res['wall_s']:.1f} s of wall time "
          f"(the two-rank launch {spawn_s:.1f} s)")
    return res


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _biobank_mesh2_rank(rank: int, device: str, work: str,
                        argv: list) -> dict:
    dev = _rank_device(rank, device)
    res = {}
    _mesh_phase(rank, res, "biobank_1m_mesh2", "segment",
                lambda: _mesh_cli(dev, Path(work) / "biobank_1m_mesh2", argv,
                                  segment=True))
    return res


def biobank_mesh2_main() -> int:
    """`python3 chip_smoke.py biobank_1m_mesh2`, outside the smoke:
    `biobank_1m` (pop_size 1e6 over the slice's scenario files, 3
    generations, in place with the per-group plan) on one card through the
    CLI, then at `--mesh ind=2` on two gloo ranks sharing the card
    (`biobank_1m_mesh2`): `.info`/`.summary` byte-identical to the one-card
    run's; per rank s/gen, exchange bytes and seconds a generation, each
    generation's peaks (before, in and after the real pass) beside the
    reckoned need, which the peak must not pass, every generation in
    place, the per-group plan's launches; the last generation's last
    launches of the stacked kernels held to their plain versions
    (`_MeshLaunches`). `/proc/meminfo`'s MemAvailable is printed and
    checked first: the gloo ranks stage their exchanges through pinned
    host memory. The same last lines as the smoke."""
    import torch

    from geneevolve_tpu_torch.ops import _build
    from geneevolve_tpu_torch.parallel import launch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    smi = _card()
    print(f" card: {smi}")
    avail = _mem_available_gib()
    print(f" MemAvailable {avail:.1f} GiB")
    if avail < BIOBANK_MESH_HOST_GIB:
        raise AssertionError(f"{avail:.1f} GiB of host memory available, "
                             f"{BIOBANK_MESH_HOST_GIB} needed")
    _build.build()
    _build.lib()
    name = "biobank_1m"
    scenario = dict(SCENARIO, pop_size=BIOBANK[name], gens=BIOBANK_GENS)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        root = work / "scenario"
        root.mkdir()
        argv = _with(_scenario(root, **SCENARIO, seed=1), "--file_gen_info",
                     str(_popinfo(root, scenario, BIOBANK_GENS)))
        one = slice_phase(dev, work, name, scenario, base=argv)
        one.pop("sim")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.launch(_biobank_mesh2_rank, 2,
                              (dev.type, str(work), argv), device=dev.type,
                              backend="gloo", timeout_s=BIG_MESH_TIMEOUT_S * 3,
                              pg_timeout_s=600)
        wall = time.perf_counter() - t0
        path = "biobank_1m_mesh2"
        n = _same_files(path, work / name, work / path,
                        _info_files(1, BIOBANK_GENS) + ["out.pop1.summary"])
        res = {"one_card": {k: one[k] for k in (
            "s_per_gen", "max_memory_allocated_mb", "peaks_per_gen_mb",
            "reckoned", "stage_split_s")}, "files_identical": n,
            "wall_s": wall}
        for r, out in enumerate(ranks):
            o = res[f"rank{r}"] = out[path]
            print(f" {path} rank {r}: s/gen "
                  + " ".join(f"{x:.3f}" for x in o["s_per_gen"])
                  + "; exchange a generation " + " ".join(
                      f"{b / 2**20:.1f} MiB/{t:.3f} s" for b, t in zip(
                          o["exchange_bytes_per_gen"][1:],
                          o["exchange_s_per_gen"][1:]))
                  + f"; peak {o['max_memory_allocated_mb']:.1f} MiB "
                  "(probe / real pass / the rest "
                  + ", ".join(f"{x['probe']:.0f}/{x['real']:.0f}/"
                              f"{x['rest']:.0f}"
                              for x in o["peaks_per_gen_mb"])
                  + f"), reckoned need {o['need_mb']:.1f} MiB"
                  + _peak_text(o))
        for r in range(2):
            o = res[f"rank{r}"]
            _expect(f"{path} rank {r}", o["launches"], _mesh_want({
                k: v * BIOBANK_GENS for k, v in PER_GROUP_PER_GEN.items()},
                o))
            _in_place_within_need(f"{path} rank {r}", o)
        print(f" {path}: {n} files byte-identical to one card's; one card "
              + " ".join(f"{x:.3f}" for x in one["s_per_gen"])
              + f" s/gen, peak {one['max_memory_allocated_mb']:.1f} MiB")
    print(json.dumps(res))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from geneevolve_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = _card()
    print(f" card: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f" build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"   {line.strip()}")
    wrappers = _wrappers()
    kernels = kernel_phase(dev) + dense_kernel_phase(dev)
    launches, res = {}, {}
    gens = SCENARIO["gens"]

    def check_per_gen(path, per_gen):
        for name, k in per_gen.items():
            want = k * PATH_GENS[path] + GEN0_LAUNCHES.get(path, {}).get(
                name, 0)
            if launches[path][name] != want:
                raise AssertionError(
                    f"{path}: {launches[path][name]} {name} launches in "
                    f"{PATH_GENS[path]} generations, {want} expected")

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        parity_phase(dev, work)
        res["slice"] = counted("segment_slice", wrappers,
                               lambda: segment_slice(dev, work), launches)
        check_per_gen("segment_slice", SEGMENT_PER_GEN)
        slice_argv, slice_root = (res["slice"].pop(k) for k in ("argv",
                                                                 "root"))
        # after the counted run: these launches are comparisons
        final = res["slice"].pop("final")
        res["slice"]["parent_launches_checked"] = segment_slice_kernels(
            kernels, res["slice"].pop("captured"))
        kernels.append(paint_full_width(dev, final))
        del final
        torch.cuda.empty_cache()
        res["gather"] = counted(
            "segment_gather", wrappers,
            lambda: segment_gather(dev, work, slice_argv, slice_root),
            launches)
        check_per_gen("segment_gather", GATHER_PER_GEN)
        del res["gather"]["argv"], res["gather"]["root"]
        gather_paint_kernel(kernels, res["gather"].pop("captured"))
        res["gather"]["parent_launches_checked"] = _recheck(
            "gather31", res["gather"].pop("parents"), children=True)[
                "checked"]
        torch.cuda.empty_cache()
        res["grow"] = counted("grow31", wrappers,
                              lambda: segment_grow(dev, work, slice_argv),
                              launches)
        _expect("grow31", launches["grow31"],
                res["grow"].pop("want_launches"))
        for k in ("argv", "root"):
            res["grow"].pop(k)
        res["grow"]["parent_launches_checked"] = _recheck(
            "grow31", res["grow"].pop("parents"), children=True)["checked"]
        torch.cuda.empty_cache()
        res["device_mating"] = counted(
            "segment_device_mating", wrappers,
            lambda: segment_device_mating(dev, work, slice_argv), launches)
        check_per_gen("segment_device_mating", SEGMENT_PER_GEN)
        del res["device_mating"]["argv"], res["device_mating"]["root"]
        res["device_mating"]["parent_launches_checked"] = _recheck(
            "dm31", res["device_mating"].pop("parents"), children=True)[
                "checked"]
        print(" segment_device_mating: mate stage "
              f"{res['device_mating']['stage_split_s']['mate']} s on the "
              f"card against table31's {res['slice']['stage_split_s']['mate']}"
              f" s on the host over {gens} generations")
        res["device_mating_parity"] = device_mating_parity(dev)
        torch.cuda.empty_cache()
        res["multipop_parity_gens"] = multipop_parity_phase(dev, work)
        res["multipop"] = counted(
            "segment_multipop", wrappers,
            lambda: segment_multipop(dev, work, slice_argv), launches)
        _expect("segment_multipop", launches["segment_multipop"],
                res["multipop"].pop("want_launches"))
        straight = {k: res["multipop"].pop(k) for k in ("argv", "root",
                                                        "ckpt")}
        # after the counted run: these launches are comparisons
        res["multipop"]["parent_launches_checked"] = multipop_kernels(
            kernels, res["multipop"].pop("captured"))
        torch.cuda.empty_cache()
        res["multipop_resume"] = counted(
            "segment_multipop_resume", wrappers,
            lambda: segment_multipop_resume(dev, straight), launches)
        _expect("segment_multipop_resume",
                launches["segment_multipop_resume"],
                res["multipop_resume"].pop("want_launches"))
        multipop_argv = straight["argv"]
        if multipop_argv[-2] != "--gamma":
            raise AssertionError("multipop31's argv ends in --gamma")
        torch.cuda.empty_cache()
        res["biobank"] = biobank_phases(dev, work, slice_argv, wrappers,
                                        launches, kernels)
        res["output_parity_files"] = segment_output_parity(dev, work)
        dense_parity_phase(dev, work)
        # 200 SNPs a chromosome: 224 loci, 7 words
        dense_parity_phase(dev, work, snps=200, label="dense_parity_odd")
        res["dense_slice"] = counted("dense_slice", wrappers,
                                     lambda: dense_slice(dev, work), launches)
        dense_argv = res["dense_slice"].pop("argv")
        dense_root = res["dense_slice"].pop("root")
        # after the counted run: these launches are comparisons
        dense_slice_kernels(kernels, res["dense_slice"].pop("captured"))
        torch.cuda.empty_cache()
        res["dense_odd"] = counted("dense_odd", wrappers,
                                   lambda: dense_odd(dev, work), launches)
        check_per_gen("dense_odd", DENSE_PER_GEN)
        del res["dense_odd"]["argv"], res["dense_odd"]["root"]
        print(" dense_odd31: s/gen " + " ".join(
            f"{x:.3f}" for x in res["dense_odd"]["s_per_gen"])
            + " (dense31 " + " ".join(
                f"{x:.3f}" for x in res["dense_slice"]["s_per_gen"]) + ")")
        # after the counted run: these launches are comparisons
        dense_slice_kernels(kernels, res["dense_odd"].pop("captured"),
                            "dense_odd", ("meiose_packed",))
        torch.cuda.empty_cache()
        big = res["biobank"]["table31_300k"]
        big_root = big.pop("root")
        res["mesh"] = mesh_phases(
            dev, work, wrappers, launches,
            dict(argv=slice_argv, root=slice_root,
                 s_per_gen=res["slice"]["s_per_gen"],
                 max_memory_allocated_mb=res["slice"][
                     "max_memory_allocated_mb"]),
            multipop_argv[:-2],
            dict(argv=dense_argv, root=dense_root,
                 s_per_gen=res["dense_slice"]["s_per_gen"],
                 max_memory_allocated_mb=res["dense_slice"][
                     "max_memory_allocated_mb"]),
            dict(argv=big.pop("argv"), root=big_root,
                 s_per_gen=big["s_per_gen"],
                 max_memory_allocated_mb=big["max_memory_allocated_mb"]))
        shutil.rmtree(big_root)
        torch.cuda.empty_cache()
        res["dense_mutations"] = counted(
            "dense_mutations", wrappers,
            lambda: dense_mutations(dev, work, dense_argv), launches)
        del res["dense_mutations"]["argv"], res["dense_mutations"]["root"]
        # after the counted run: these launches are comparisons
        dense_mutation_kernels(kernels,
                               res["dense_mutations"].pop("captured"))
        torch.cuda.empty_cache()
        res["dense_multipop"] = counted(
            "dense_multipop", wrappers,
            lambda: dense_multipop(dev, work, dense_argv), launches)
        check_per_gen("dense_multipop", DENSE_MULTIPOP_PER_GEN)
        torch.cuda.empty_cache()
        res["dense_device_mating"] = counted(
            "dense_device_mating", wrappers,
            lambda: dense_device_mating(dev, work, dense_argv), launches)
        check_per_gen("dense_device_mating", DENSE_PER_GEN)
        print(" dense_device_mating: mate stage "
              f"{res['dense_device_mating']['stage_split_s']['mate']} s on "
              f"the card over {DENSE_DM_GENS} generations (dense31's host "
              f"mate {res['dense_slice']['stage_split_s']['mate']} s over "
              f"{DENSE_SCENARIO['gens']})")
        torch.cuda.empty_cache()
        res["scenario_parity_files"] = scenario_parity(dev, work)
        res["scenario31"] = counted(
            "scenario31", wrappers,
            lambda: scenario31(dev, work, dense_argv), launches)
        check_per_gen("scenario31", DENSE_PER_GEN)
        straight = {k: res["scenario31"].pop(k) for k in ("final",
                                                          "resume_argv")}
        res["scenario31_resume"] = counted(
            "scenario31_resume", wrappers,
            lambda: scenario31_resume(dev, straight), launches)
        check_per_gen("scenario31_resume", DENSE_PER_GEN)
        del straight
        torch.cuda.empty_cache()
        res["output"] = counted(
            "segment_output", wrappers,
            lambda: segment_output_full(dev, work, dense_argv), launches)
        if launches["segment_output"]["paint"] != SCENARIO["nchr"]:
            raise AssertionError("segment output: one paint launch a "
                                 "chromosome expected")
        del res["output"]["argv"], res["output"]["root"]
        res["profile"] = counted(
            "segment_profiled", wrappers,
            lambda: profile_phase(dev, work, slice_argv), launches)
        del res["profile"]["argv"], res["profile"]["root"]
    torch.cuda.empty_cache()
    res["packed_engine"] = counted("packed_engine", wrappers,
                                   lambda: packed_engine_phase(dev), launches)
    if launches["packed_engine"]["meiose_packed"] != 6:
        raise AssertionError("packed engine: one meiosis launch per "
                             "generation expected")
    torch.cuda.empty_cache()
    res["packed_engine_odd"] = counted(
        "packed_engine_odd", wrappers,
        lambda: packed_engine_phase(dev, FLAGSHIP_ODD), launches)
    if launches["packed_engine_odd"]["meiose_packed"] != 6:
        raise AssertionError("packed engine (odd): one meiosis launch per "
                             "generation expected")
    print(" packed_engine_odd: "
          f"{res['packed_engine_odd']['ind_loci_gens_per_s']:.4g} "
          "ind.loci.gens/s at 4,095 words a chromosome, against "
          f"{res['packed_engine']['ind_loci_gens_per_s']:.4g} at 4,096")
    torch.cuda.empty_cache()
    res["streamed"] = counted("streamed", wrappers,
                              lambda: streamed_phase(dev), launches)
    check_per_gen("streamed", {"meiose_packed": STREAMED_SLABS})
    # after the counted run: these launches are comparisons
    streamed_check(res["streamed"].pop("captured"))
    print(f" streamed: {res['streamed']['ind_loci_gens_per_s']:.4g} "
          "ind.loci.gens/s with the genome in host memory, against the "
          f"packed engine's {res['packed_engine']['ind_loci_gens_per_s']:.4g}"
          " resident (flagship shape)")
    torch.cuda.empty_cache()
    res["byte_engine"] = counted("byte_engine", wrappers,
                                 lambda: byte_engine_phase(dev), launches)
    for k in kernels:
        home = HOME_PATH[k["name"]]
        k["launches"] = launches[home][k["name"]]
        k["launches_per_gen"] = (k["launches"] - GEN0_LAUNCHES.get(
            home, {}).get(k["name"], 0)) / PATH_GENS[home]
        k["launches_by_path"] = {p: launches[p][k["name"]]
                                 for p, ks in PATHS.items() if k["name"] in ks}
        windows = {p: w[k["name"]] for p, w in WINDOW_LAUNCHES.items()
                   if w.get(k["name"])}
        if windows:
            k["window_launches_by_path"] = windows
    print(json.dumps(res))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(biobank_mesh2_main() if sys.argv[1:] == [
        "biobank_1m_mesh2"] else main())
