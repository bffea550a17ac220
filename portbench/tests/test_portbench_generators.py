"""The copied generators: the genome and FASTA reads equal the port's
``sim`` at a small size and seed; the vectorised alchemy copy keeps the
loop's length, error and quality distribution."""

import numpy as np

from portbench.generators import alchemy, genome, parse_truth, simulate_reads
from blasr_tpu_torch import sim


def test_genome_equals_port():
    assert np.array_equal(genome.simulate_genome(60_000, seed=5),
                          sim.simulate_genome(60_000, seed=5))


def test_reads_equal_port():
    g = sim.simulate_genome(60_000, seed=5)
    ours = simulate_reads.simulate_reads(g, 40, mean_len=700, seed=9)
    theirs, _ = sim.simulate_reads(g, 40, mean_len=700, seed=9)
    assert [n for n, _, _ in ours] == [r.name for r in theirs]
    assert all(np.array_equal(c, r.codes) for (_, c, _), r in zip(ours, theirs))


def test_fixed_lengths_across_seeds():
    g = sim.simulate_genome(60_000, seed=5)
    tr = {"mean_len": 500, "min_len": 100, "sub_rate": 0.01, "ins_rate": 0.08,
          "del_rate": 0.04, "length_seed": 3}
    spans = []
    for seed in (1, 2**33 + 7):
        reads = simulate_reads.generate(g, tr, 50, seed)
        spans.append(sorted(e - s for s, e, _ in (parse_truth(n) for n, _, _ in reads)))
    assert spans[0] == spans[1]


def _stats(reads_of):
    """(out/true length ratio, substitution, insertion and deletion rates,
    share of strand 1) of reads from a model whose match quality clips to
    60 and marks substitutions 92 and insertions 90."""
    n_true = n_out = n_sub = n_ins = 0
    strands = []
    for name, codes, qual in reads_of:
        s, e, strand = parse_truth(name)
        n_true += e - s
        n_out += len(codes)
        n_sub += int((qual == 92).sum())
        n_ins += int((qual == 90).sum())
        strands.append(strand)
    n_del = n_true - (n_out - n_ins)
    return (n_out / n_true, n_sub / n_true, n_ins / n_true, n_del / n_true,
            float(np.mean(strands)))


def test_alchemy_keeps_the_distribution():
    g = sim.simulate_genome(200_000, seed=5)
    model = sim.ErrorModel.published_clr()
    model.mean_qual = 100.0          # quality marks each error kind (see _stats)
    theirs, _ = sim.simulate_reads_alchemy(g, model, 300, seed=4)
    loop = [(r.name, r.codes, r.qual) for r in theirs]
    lengths = [e - s for s, e, _ in (parse_truth(n) for n, _, _ in loop)]
    m = {"sub": model.sub, "ins": model.ins, "dele": model.dele,
         "mean_qual": model.mean_qual, "ins_cognate": model.ins_cognate}
    ours = alchemy.simulate_reads(g, m, lengths, seed=4)
    a, b = _stats(loop), _stats(ours)
    assert abs(a[0] - b[0]) < 0.01                 # length ratio
    for x, y in zip(a[1:4], b[1:4]):               # error rates within 6% of themselves
        assert abs(x - y) < 0.06 * x, (a, b)
    assert 0.4 < b[4] < 0.6
    # match quality: clip(N(mean, 4), 4, 60) in both
    q_loop = np.concatenate([q for _, _, q in loop])
    q_ours = np.concatenate([q for _, _, q in ours])
    assert set(np.unique(q_ours)) <= set(np.unique(q_loop))


def test_alchemy_match_quality_distribution():
    g = sim.simulate_genome(100_000, seed=6)
    model = sim.ErrorModel.published_clr()
    theirs, _ = sim.simulate_reads_alchemy(g, model, 200, seed=8)
    lengths = [e - s for s, e, _ in (parse_truth(r.name) for r in theirs)]
    m = {"sub": model.sub, "ins": model.ins, "dele": model.dele,
         "mean_qual": model.mean_qual, "ins_cognate": model.ins_cognate}
    ours = alchemy.simulate_reads(g, m, lengths, seed=8)
    q_loop = np.concatenate([r.qual for r in theirs]).astype(float)
    q_ours = np.concatenate([q for _, _, q in ours]).astype(float)
    assert abs(q_loop.mean() - q_ours.mean()) < 0.1
    assert abs(np.percentile(q_loop, 90) - np.percentile(q_ours, 90)) <= 1
