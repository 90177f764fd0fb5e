"""The port's segment-backend outputs against the JAX package's, on the
CPU, in whole runs fed the JAX run's mating and reproduce plans (as
`test_torch_engine.py` feeds them): genotype files (`.hap`/`.indv`,
`.vcf`, `.ped`/`.map`, `.int`, `.cvval`) byte-identical for each output
flag, `--file_ref_vcf` panels on both backends, and the gather A/D path
(no resident CV matrix, one-pass and two-pass) against the resident run
and the JAX gather path. `.info` / `.summary` agree within
`test_torch_engine`'s stated tolerance (f32 row sums in another order);
between the port's own resident and gather runs they are byte-identical
(the same alleles through the same arithmetic).
"""

import filecmp
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from geneevolve_tpu.config import parse_args as jax_parse_args
from geneevolve_tpu.core import engine as jax_engine
from geneevolve_tpu.core import mating
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core import output as toutput
from geneevolve_tpu_torch.dense import backend as tbackend
from test_torch_dense import JaxDenseRun
from test_torch_engine import _argv, _assert_table_close, _mutation_map

# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


class Plans:
    """A JAX engine run through `run()` (outputs included) with every
    generation's mating plan and reproduce plan kept, to feed the port."""

    def __init__(self, argv):
        self.mates, self.plans = [], []
        probe, assort = jax_engine._capacity_probe, mating.assort_mate

        def probe_rec(*a, **k):
            out = probe(*a, **k)
            self.plans.append(tuple(np.asarray(x) for x in out[2]))
            return out

        def assort_rec(*a, **k):
            plan = assort(*a, **k)
            self.mates.append(plan)
            return plan

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_engine, "_capacity_probe", probe_rec)
            mp.setattr(mating, "assort_mate", assort_rec)
            self.sim = jax_engine.Simulation(jax_parse_args(argv),
                                             verbose=False)
            self.sim.run()

    def port_run(self, argv, **kw):
        """The port's `Simulation.run()` on the CPU, fed these plans."""
        tsim = torch_engine.Simulation(parse_args(argv), device="cpu",
                                       verbose=False, **kw)
        tsim._mate = lambda p, gen, pop_size, g: self.mates[gen - 1]
        tsim._plan = lambda p, gen, n_pad: tuple(
            torch.from_numpy(np.array(x)) for x in self.plans[gen - 1])
        tsim.run()
        return tsim


def _dirs(tmp_path):
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    return tmp_path / "jax", tmp_path / "torch"


def _files_match(jdir: Path, tdir: Path, min_genotype_files: int):
    """Same file set; every genotype file byte-identical; `.info` and
    `.summary` within the stated tolerance."""
    names = sorted(x.name for x in jdir.iterdir())
    assert names == sorted(x.name for x in tdir.iterdir())
    geno = [x for x in names
            if not (x.startswith("out.info.") or x.endswith(".summary"))]
    assert len(geno) >= min_genotype_files, geno
    for x in geno:
        assert filecmp.cmp(jdir / x, tdir / x, shallow=False), x
    for x in names:
        if x not in geno:
            _assert_table_close(tdir / x, jdir / x)
    return geno


OUTPUT_FLAGS = {  # flag -> (extra argv, suffixes it writes)
    "out_hap": (["--out_hap"], {"hap", "indv"}),
    "out_vcf": (["--out_vcf"], {"vcf"}),
    "out_plink": (["--out_plink"], {"ped", "map"}),
    "out_plink01": (["--out_plink01"], {"ped", "map"}),
    "out_interval": (["--out_interval"], {"int"}),
    "debug": (["--debug"], {"cvval"}),
    "file_output_generations": (["--out_vcf", "--file_output_generations"],
                                {"vcf"}),
}


@pytest.mark.parametrize("flag", sorted(OUTPUT_FLAGS))
def test_segment_output_files_match_jax(flag, mini_scenario, tmp_path,
                                        capsys):
    """Each output flag on the segment backend, with a mutation map (so
    painting flips alleles): the port's files equal the JAX package's."""
    extra, suffixes = OUTPUT_FLAGS[flag]
    if flag == "file_output_generations":
        (tmp_path / "gens.txt").write_text("1\n3\n")
        extra = extra + [str(tmp_path / "gens.txt")]
    mmap = _mutation_map(tmp_path / "mut.txt")
    jdir, tdir = _dirs(tmp_path)
    run = Plans(_argv(mini_scenario, jdir / "out", mmap) + extra)
    jax_out = capsys.readouterr().out
    tsim = run.port_run(_argv(mini_scenario, tdir / "out", mmap) + extra)
    torch_out = capsys.readouterr().out
    geno = _files_match(jdir, tdir, 2 * len(suffixes))
    assert {x.rsplit(".", 1)[-1] for x in geno} == suffixes
    gens = {int(x.split(".gen")[1].split(".")[0]) for x in geno}
    assert gens == ({1, 3} if flag == "file_output_generations" else {4})
    if flag == "debug":  # the map spot-check lines, as the JAX run prints
        lines = [x for x in jax_out.splitlines() if "rmap" in x
                 or "recom_prob" in x]
        assert len(lines) == 6
        assert lines == [x for x in torch_out.splitlines() if "rmap" in x
                         or "recom_prob" in x]
    if flag == "out_interval":  # the merge keeps every part boundary
        assert not tsim.merge_ibd
        assert all(c["seg_used"] <= c["seg_need"] for c in tsim.capacity_log)
    assert (tsim.pops[0].state.mut < 2**30).any()  # mutations were carried


def test_debug_prints_allele_frequencies(mini_scenario, tmp_path, capsys):
    """`--debug` with painted output prints the last SNPs' allele
    frequencies (`Simulation.cpp:1368-1387`), as the JAX package does."""
    extra = ["--debug", "--out_plink"]
    jdir, tdir = _dirs(tmp_path)
    run = Plans(_argv(mini_scenario, jdir / "out") + extra)
    want = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("AF =")]
    run.port_run(_argv(mini_scenario, tdir / "out") + extra)
    got = [x for x in capsys.readouterr().out.splitlines()
           if x.startswith("AF =")]
    assert len(want) == 2 * 10 and got == want


def _write_vcf(path, pos, hap, samples, chrom="1"):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n##Phasing=phased\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        for j in range(len(pos)):
            gts = "\t".join(f"{hap[2 * i, j]}|{hap[2 * i + 1, j]}"
                            for i in range(len(samples)))
            f.write(f"{chrom}\t{pos[j]}\trs{j}\tA\tG\t30\tPASS\t.\tGT\t"
                    f"{gts}\n")


@pytest.fixture(scope="module")
def vcf_scenario(tmp_path_factory):
    """A VCF founder panel (30 samples, 100 SNPs on one chromosome), as
    `tests/test_vcf_path.py` builds it, with a QUAL column the output must
    copy."""
    root = tmp_path_factory.mktemp("vcfsc")
    rng = np.random.default_rng(11)
    n0, nsnp, ncv = 30, 100, 6
    pos = np.sort(rng.choice(np.arange(1_000_000, 30_000_000), nsnp, False))
    hap = rng.integers(0, 2, size=(2 * n0, nsnp), dtype=np.uint8)
    _write_vcf(root / "ref.chr1.vcf", pos, hap, [f"s{i}" for i in range(n0)])
    cv_cols = np.sort(rng.choice(nsnp, ncv, replace=False))
    np.savetxt(root / "cv.chr1.hap", hap[:, cv_cols].T, fmt="%d")
    (root / "cv.info").write_text("chr pos a d\n" + "".join(
        f"1 {pos[i]} {rng.normal()} 0\n" for i in cv_cols))
    (root / "vcf_address.txt").write_text(f"chr vcf\n1 {root}/ref.chr1.vcf\n")
    (root / "cv_address.txt").write_text(f"1 {root}/cv.chr1.hap\n")
    (root / "popinfo.txt").write_text(
        "pop_size mat_cor offspring_dist selection_func selection_func_par1 "
        "selection_func_par2\n" + "40 0.1 p thr 1 1\n" * 3)
    (root / "rmap.txt").write_text("chr bp cM\n" + "".join(
        f"1 {bp} {bp / 1_000_000:.6f}\n"
        for bp in range(0, 40_000_000, 50_000)))
    return root


def _vcf_argv(root: Path, prefix: Path):
    return ["--file_gen_info", str(root / "popinfo.txt"),
            "--file_ref_vcf", str(root / "vcf_address.txt"),
            "--file_recom_map", str(root / "rmap.txt"),
            "--file_cv_info", str(root / "cv.info"),
            "--file_cvs", str(root / "cv_address.txt"),
            "--seed", "55", "--prefix", str(prefix)]


def test_file_ref_vcf_segment_matches_jax(vcf_scenario, tmp_path):
    """A VCF founder panel on the segment backend: `.vcf` (QUAL and FILTER
    copied from the panel), `.hap`, `.ped` and `.int` (gen0_indv from the
    VCF's sample names) equal the JAX package's."""
    extra = ["--out_vcf", "--out_hap", "--out_plink", "--out_interval"]
    jdir, tdir = _dirs(tmp_path)
    run = Plans(_vcf_argv(vcf_scenario, jdir / "out") + extra)
    tsim = run.port_run(_vcf_argv(vcf_scenario, tdir / "out") + extra)
    assert tsim.pops[0].indv_ids[:2] == ["s0", "s1"]
    _files_match(jdir, tdir, 6)
    assert "\t30\tPASS\t" in (tdir / "out.pop1.gen3.chr1.vcf").read_text()
    assert " s" in (tdir / "out.pop1.gen3.chr1.int").read_text()


def test_file_ref_vcf_dense_matches_jax(vcf_scenario, tmp_path):
    """A VCF founder panel on the dense backend: the JAX dense run's draws
    fed to the port; genotype files byte-identical."""
    extra = ["--backend", "dense", "--out_vcf", "--out_hap", "--out_plink"]
    jdir, tdir = _dirs(tmp_path)
    run = JaxDenseRun(_vcf_argv(vcf_scenario, jdir / "out") + extra)
    tsim = tbackend.DenseSimulation(
        parse_args(_vcf_argv(vcf_scenario, tdir / "out") + extra),
        device="cpu", verbose=False)
    run.inject(tsim)
    tsim.init_generation0()
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
    tsim.write_summary()
    tsim.save_genotypes(tsim.tot_gen)
    tsim._io_pool.shutdown(wait=True)
    _files_match(jdir, tdir, 5)
    assert "\t30\tPASS\t" in (tdir / "out.pop1.gen3.chr1.vcf").read_text()


def _info_bytes(d: Path):
    return {x.name: x.read_bytes() for x in sorted(d.iterdir())
            if x.name.startswith("out.info.") or x.name.endswith(".summary")}


@pytest.mark.parametrize("chunk", [None, "32"])
def test_gather_path_matches_resident_and_jax(chunk, mini_scenario, tmp_path,
                                              monkeypatch):
    """GE_NO_RESIDENT_CV=1: A/D painted from the ledger (one pass, or with
    GE_AD_CHUNK=32 two passes over ~4 row chunks, global allele counts
    first). The port's `.info` / `.summary` equal its resident run byte for
    byte and the JAX gather path's within the tolerance; `.cvval` (final
    generation, from the painted alleles) byte-identical to both."""
    mmap = _mutation_map(tmp_path / "mut.txt")
    extra = ["--debug"] if chunk is None else []
    (tmp_path / "resident").mkdir()
    jdir, tdir = _dirs(tmp_path)
    monkeypatch.setenv("GE_NO_RESIDENT_CV", "1")
    if chunk is not None:
        monkeypatch.setenv("GE_AD_CHUNK", chunk)
    run = Plans(_argv(mini_scenario, jdir / "out", mmap) + extra)
    assert not run.sim.resident_cv
    painted, paint = [], torch_engine.paint

    def paint_rec(*a):
        painted.append(a[0].shape[1])
        return paint(*a)

    monkeypatch.setattr(torch_engine, "paint", paint_rec)
    tsim = run.port_run(_argv(mini_scenario, tdir / "out", mmap) + extra)
    monkeypatch.undo()
    assert not tsim.resident_cv and tsim.pops[0].state.cv is None
    rows = tsim.pops[0].state.seg_st.shape[1]
    if chunk is None:  # one launch a generation (one phenotype)
        assert painted == [painted[0]] * (tsim.tot_gen + 1)
    else:  # two passes over the row chunks, a generation
        per_gen = 2 * -(-rows // 32)
        assert len(painted) == (tsim.tot_gen + 1) * per_gen
        assert max(painted) == 32
    _files_match(jdir, tdir, 2 if chunk is None else 0)
    res = run.port_run(_argv(mini_scenario, tmp_path / "resident" / "out",
                             mmap) + extra)
    assert res.resident_cv
    assert _info_bytes(tdir) == _info_bytes(tmp_path / "resident")
    for x in (tmp_path / "resident").glob("*.cvval"):
        assert filecmp.cmp(x, tdir / x.name, shallow=False)


def test_paint_chunks_cover_rows_and_loci(mini_scenario, tmp_path,
                                          monkeypatch):
    """`paint_chunks` in chunks of rows and loci (as `_chunks` sizes them
    when the card's memory is short) gives the whole chromosome, and
    `paint_chromosome` equals the JAX package's on the same ledger."""
    from geneevolve_tpu.core import output as joutput

    mmap = _mutation_map(tmp_path / "mut.txt")
    run = Plans(_argv(mini_scenario, tmp_path / "jax", mmap))
    st = run.sim.pops[0].state
    led = [np.array(x[1, : st.n]) for x in (st.seg_st, st.seg_hap, st.mut)]
    legends, founder = toutput._load_founder_chr(run.sim, 1)
    pos = toutput._legend_pos(legends[0])
    want = joutput.paint_chromosome(*led, founder, pos)
    T = [torch.as_tensor(x) for x in led]
    assert np.array_equal(toutput.paint_chromosome(*T, founder, pos), want)
    monkeypatch.setattr(toutput, "_chunks", lambda n, m, H, dev: (7, 33))
    chunks = list(toutput.paint_chunks(*T, founder, pos))
    assert [lo for lo, _ in chunks] == list(range(0, len(pos), 33))
    assert np.array_equal(np.concatenate([b for _, b in chunks], 2), want)
    # `_chunks` on a card with little free memory: loci in spans, then rows
    monkeypatch.undo()
    span = toutput._SPAN  # the kernel's loci a block
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (2 * 50_000 * span, 80 << 30))
    rc, mc = toutput._chunks(30_000, 14_588, 20_000, torch.device("cuda"))
    assert (rc, mc) == (15_000, span)  # half the free memory: 50,000 spans
    assert 2 * rc * mc + 20_000 * mc <= 50_000 * span


def test_check_fits_takes_gather_path_when_short(mini_scenario, tmp_path,
                                                 monkeypatch, capsys):
    """Where the resident matrix run does not fit the card's free memory,
    `_check_fits` moves the run to the gather path, logging the JAX
    package's `[mem] ... using the gather path` line, and no longer
    raises."""
    sim = torch_engine.Simulation(parse_args(_argv(mini_scenario,
                                                   tmp_path / "out")),
                                  device="cpu", verbose=True)
    assert sim.resident_cv
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 10, 80 << 30))
    sim.device = torch.device("cuda")
    sim._check_fits()
    assert not sim.resident_cv and sim.gather_chunk == 1
    assert "using the gather path" in capsys.readouterr().out


def test_profile_writes_trace(mini_scenario, tmp_path):
    """`--profile DIR`: a `torch.profiler` trace of the whole run lands in
    DIR (CPU activity here; the card's kernels too on CUDA), from the load
    through the summary: it holds the run's `load`, `generation0`, `step`
    and `summary` spans."""
    trace = tmp_path / "trace"
    sim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "out")
                   + ["--profile", str(trace)]),
        device="cpu", verbose=False)
    sim.run()
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 1000
    spans = [e["name"] for e in json.loads(files[0].read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"]
    for name in ("load", "generation0", "summary"):
        assert spans.count(name) == 1, name
    assert spans.count("step") == sim.tot_gen
