"""--extend and --onegap through the PyTorch port on the CPU against the
JAX package: tests/test_extend_scoring.py's trimmed-end world and reads
with noisy heads and tails on tests/test_onegap.py's genome (where the
alignments of two reads start late and the extension grows them; the
card's smoke maps these with the spliced read) mapped with alignment
extension (every alignment's coordinates, CIGAR, score and
match/mismatch/indel counts identical), and tests/test_onegap.py's
spliced read through both CLIs on both strands (identical SAM text
without @PG, one 4000N skip)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.cli.blasr import run as jax_run  # noqa: E402
from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord, revcomp, write_fasta  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import mutate, random_genome, simulate_reads  # noqa: E402
from blasr_tpu_torch.cli.blasr import run as port_run  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402

torch.set_num_threads(2)


def sam_body(path):
    """SAM text without the @PG line (it embeds the command line)."""
    return "".join(l for l in open(path) if not l.startswith("@PG"))


def noisy_end_reads(g):
    """Six reads of ~700 b from ``g``: a 150 b head and tail with 20-40%
    error (0% for one tail) around 400 b at 6% error."""
    rng = np.random.default_rng(53)
    recs = []
    for i, (head, tail) in enumerate(((0.3, 0.3), (0.25, 0.25),
                                      (0.35, 0.2), (0.2, 0.35), (0.3, 0.0),
                                      (0.4, 0.4))):
        s = 5000 + 7000 * i
        parts = [mutate(g[s:s + 150], rng, 0.4 * head, 0.3 * head,
                        0.3 * head),
                 mutate(g[s + 150:s + 550], rng, 0.02, 0.02, 0.02),
                 mutate(g[s + 550:s + 700], rng, 0.4 * tail, 0.3 * tail,
                        0.3 * tail)]
        recs.append(FastaRecord(f"noisy/{i}/0_700",
                                np.concatenate(parts).astype(np.int8)))
    return recs


@pytest.mark.parametrize("world", ["trimmed-end", "noisy-ends"])
def test_extend_matches_jax(world):
    contigs = random_genome(60_000, seed=51 if world == "trimmed-end"
                            else 201)
    gi = build_genome_index(contigs, k=12)
    if world == "trimmed-end":
        recs = [s.rec for s in simulate_reads(
            contigs, 6, read_len=(400, 700), accuracy=0.9, seed=52)]
    else:
        recs = noisy_end_reads(contigs[0].seq)
    p = MappingParams(extend_alignments=True, min_read_length=50).make_sane()
    cfg = ShapeConfig(buckets=(1024,), batch_size=8)
    want = jmr.Mapper(gi, p, cfg).map_reads(recs)
    got = tmr.Mapper(gi, p, cfg, device="cpu").map_reads(recs)

    def fields(per_read):
        return [[(a.strand, a.tindex, a.tstart, a.tend, a.qstart, a.qend,
                  list(a.cigar), a.score, a.n_match, a.n_mismatch, a.n_ins,
                  a.n_del) for a in alns] for alns in per_read]

    assert fields(got) == fields(want)
    assert all(got), "a read did not map"


@pytest.mark.parametrize("rc", [False, True])
def test_onegap_spliced_read_matches_jax(tmp_path, rc):
    contigs = random_genome(60_000, seed=202 if rc else 201)
    g = contigs[0].seq
    # a read spanning a 4 kb "intron": 300 bp + 300 bp from distant loci
    read = np.concatenate([g[10_000:10_300], g[14_300:14_600]])
    if rc:
        read = revcomp(read)
    d = str(tmp_path)
    write_fasta(os.path.join(d, "g.fa"), contigs)
    write_fasta(os.path.join(d, "r.fa"),
                [FastaRecord("spliced/1/0_600", read)])
    args = [os.path.join(d, "r.fa"), os.path.join(d, "g.fa"), "--sam",
            "--onegap", "--bestn", "2", "--hitPolicy", "all"]
    assert jax_run(args + ["--out", os.path.join(d, "jax.sam")]) == 0
    assert port_run(args + ["--out", os.path.join(d, "port.sam"),
                            "--device", "cpu"]) == 0
    got = sam_body(os.path.join(d, "port.sam"))
    assert got == sam_body(os.path.join(d, "jax.sam"))
    cigars = [l.split("\t")[5] for l in got.splitlines()
              if not l.startswith("@")]
    assert any("4000N" in c for c in cigars), cigars
