"""One run of a cell: set-up, the measured window, the traced chunks and
the check, on the device given (``cuda``; ``cpu`` for the dry runs of
the tests, where the program's plain versions stand in for its kernels).
"""

from __future__ import annotations

import dataclasses
import io
import os
import time

import numpy as np

from portbench import generators
from portbench.generators import genome as genome_gen
from portbench.harness import check as check_mod
from portbench.harness.spec import PKG, Bench

CACHE = os.path.join(PKG, ".cache")


def mapping_setup(flags: list[str]):
    """(MappingParams, output format, clipping) of a BLASR command line, by
    the program's own parser."""
    from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args

    args = build_arg_parser().parse_args(["reads", "genome", *flags])
    params = params_from_args(args)
    params.validate()
    if not args.sam and args.m != 4:
        raise ValueError("the harness writes -m 4 or SAM; give -m 4 or -sam")
    return params, ("sam" if args.sam else "m4"), args.clipping


def true_locus_hits(records, reads) -> int:
    """Reads whose best (lowest-score) record lies on the true strand within
    100 bp of the simulated start and end (the simulators' truth)."""
    best: dict = {}
    for r in records:
        cur = best.get(r.qname)
        if cur is None or r.score < cur.score:
            best[r.qname] = r
    hits = 0
    for rd in reads:
        rec = best.get(rd.name)
        if rec is None:
            continue
        start, end, strand = generators.parse_truth(rd.name)
        if rec.tstrand == strand and abs(rec.tstart_fwd - start) < 100 \
                and abs(rec.tend_fwd - end) < 100:
            hits += 1
    return hits


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    chunks: int = 0
    reads: int = 0
    bases: int = 0
    hits: int = 0
    missing: int = 0
    write_s: float = 0.0
    texts: dict = dataclasses.field(default_factory=dict)
    chunk_s: list = dataclasses.field(default_factory=list)
    metrics: object = None
    peak_bytes: int = 0


class CellRun:
    """The cell ``bench`` on ``device``, its set-up clocked from ``t_start``
    (the process's start)."""

    def __init__(self, bench: Bench, device: str = "cuda", t_start: float | None = None,
                 control: bool = False, map_fn=None):
        self.bench = bench
        self.device = device
        self.cuda = device.startswith("cuda")
        self.t_start = time.perf_counter() if t_start is None else t_start
        flags = list(bench.config["flags"])
        if control:
            flags += list(bench.checks["control"]["flags"])
        self.flags = flags
        self.map_fn = map_fn
        self.setup_parts: dict[str, float] = {}

    # ---- set-up ----
    def _part(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + now - t0
        return now

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def setup(self) -> None:
        t = time.perf_counter()
        import torch

        from blasr_tpu_torch.index.artifacts import load_index
        from blasr_tpu_torch.ops import _build
        from blasr_tpu_torch.pipeline import runner
        from blasr_tpu_torch.pipeline.mapper import make_device_index

        self.torch = torch
        self.run_mapping = self.map_fn or runner.run_mapping
        self.MappingMetrics = runner.MappingMetrics
        self.params, self.fmt, self.clipping = mapping_setup(self.flags)
        if self.cuda:
            torch.cuda.init()
            torch.zeros(1, device=self.device)
        self.setup_parts["imports_cuda"] = time.perf_counter() - self.t_start
        t = time.perf_counter()
        if self.cuda:
            _build.load_library()
        _build.load_host_library()
        t = self._part("kernels", t)

        gspec = self.bench.config["genome"]
        os.makedirs(CACHE, exist_ok=True)
        self.genome = genome_gen.from_config(gspec)
        fasta = os.path.join(CACHE, f"{gspec['name']}.{gspec['length']}.{gspec['seed']}.fasta")
        if not os.path.exists(fasta):
            generators.write_genome(fasta, gspec["name"], self.genome)
        t = self._part("genome", t)
        self.index = load_index(fasta, k=self.params.min_match_length)
        make_device_index(self.index, self.params, self.device)
        self._sync()
        t = self._part("index", t)
        self.index_s = self.setup_parts["index"]

    def make_pool(self, seed: int):
        """The cell's reads from ``seed``: written to the cache as FASTA or
        FASTQ and parsed back by the program's reader; returns the chunks."""
        from blasr_tpu_torch.io.batching import read_records

        t = time.perf_counter()
        tr = self.bench.traffic
        chunk = (int(tr["chunk_batches"]) * self.params.batch_size
                 if "chunk_batches" in tr else int(tr["chunk_reads"]))
        n = chunk * int(tr["pool_chunks"])
        gen = generators.load(tr["generator"])
        made = gen.generate(self.genome, tr, n, seed & (2**63 - 1))
        fastq = tr["format"] == "fastq"
        os.makedirs(os.path.join(CACHE, "pool"), exist_ok=True)
        self.pool_path = os.path.join(CACHE, "pool", f"{self.bench.name}.{'fastq' if fastq else 'fasta'}")
        generators.write_reads(self.pool_path, made, fastq)
        reads = read_records(self.pool_path)
        self.truth = {name: (codes, qual) for name, codes, qual in made}
        self.chunks = [reads[i : i + chunk] for i in range(0, n, chunk)]
        self.chunk_bases = [sum(len(r) for r in c) for c in self.chunks]
        self._part("pool", t)
        return self.chunks

    def warmup(self) -> None:
        """Map reads spread over the pool's lengths once: every length
        bucket the traffic fills runs its shapes before the window."""
        t = time.perf_counter()
        pool = [r for c in self.chunks for r in c]
        order = sorted(range(len(pool)), key=lambda i: len(pool[i]))
        n_pick = int(self.bench.traffic.get("warmup_reads", 64))
        pick = sorted(set(np.linspace(0, len(order) - 1, n_pick).astype(int).tolist()))
        self._map([pool[order[i]] for i in pick], self.MappingMetrics())
        self._sync()
        self._part("warmup", t)

    def trace_part(self, chunk):
        """The batch-size worth of ``chunk``'s reads nearest its median
        length, in chunk order: the part the traced run profiles or clocks
        (a whole chunk's million launches would outlast the run under the
        profiler)."""
        lens = np.array([len(r) for r in chunk])
        med = np.median(lens)
        near = np.argsort(np.abs(lens - med), kind="stable")[: self.params.batch_size]
        return [chunk[i] for i in sorted(near)]

    # ---- the window ----
    def _map(self, reads, met, **kw):
        return self.run_mapping(self.index, reads, self.params, device=self.device,
                                metrics=met, **kw)

    def _write(self, records, unmapped, reads) -> str:
        buf = io.StringIO()
        if self.fmt == "sam":
            from blasr_tpu_torch.output.sam_writer import write_sam

            write_sam(records, reads, self.index.seqdb, buf, clipping=self.clipping,
                      program_line="blasr_tpu_torch " + " ".join(self.flags),
                      unmapped=unmapped, movie_name=os.path.basename(self.pool_path),
                      genome=self.index.genome, samqv=self.params.samqv)
        else:
            from blasr_tpu_torch.output.m4 import write_m4

            write_m4(records, buf)
        return buf.getvalue()

    def window(self, seconds: float) -> Window:
        """Map the pool's chunks in turn, each written by the CLI's writer,
        until ``seconds`` have passed; the window ends with the last whole
        chunk."""
        torch = self.torch
        w = Window(metrics=self.MappingMetrics())
        self._sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = []
        while True:
            ci = len(done) % len(self.chunks)
            met = self.MappingMetrics()
            records, unmapped = self._map(self.chunks[ci], met)
            tw = time.perf_counter()
            w.texts[ci] = self._write(records, unmapped, self.chunks[ci])
            w.write_s += time.perf_counter() - tw
            done.append((ci, records, unmapped, met))
            now = time.perf_counter()
            w.chunk_s.append(now - t0 - sum(w.chunk_s))
            if now - t0 >= seconds:
                break
        self._sync()
        w.seconds = time.perf_counter() - t0
        if self.cuda:
            w.peak_bytes = int(torch.cuda.max_memory_allocated())
        # the harness's own reading of the chunks, after the window closed
        for ci, records, unmapped, met in done:
            chunk = self.chunks[ci]
            answered = {r.qname for r in records} | set(unmapped)
            w.missing += sum(1 for r in chunk if r.name not in answered)
            w.hits += true_locus_hits(records, chunk)
            w.reads += len(chunk)
            w.bases += self.chunk_bases[ci]
            w.metrics.add(met)
        w.chunks = len(done)
        return w

    def end_to_end(self, w: Window, setup_s: float) -> dict:
        vals = {
            "bases_per_s": w.bases / w.seconds,
            "true_locus_pct": 100.0 * w.hits / max(w.reads, 1),
            "peak_device_gib": w.peak_bytes / 2**30,
            "setup_s": setup_s,
        }
        return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                for m in self.bench.end_to_end() if m["name"] in vals}

    # ---- the check ----
    def check(self, w: Window, seed: int) -> tuple[bool, dict, dict]:
        """(correct, {number: (value, limit)}, details) of the window's output."""
        lim = self.bench.checks["limits"]
        names = [r.name for i in sorted(w.texts) for r in self.chunks[i]]
        got = check_mod.judge(
            self.fmt, [w.texts[i] for i in sorted(w.texts)], names, self.truth, self.genome,
            self.bench.config["scoring"], int(self.bench.checks["sample_records"]), seed,
            w.missing, device=self.device)
        details = {"sampled_records": got.pop("_sampled_records"),
                   "below_optimum": got.pop("_below_optimum"),
                   "odd_records": got.pop("_odd_records")}
        numbers = {k: (v, lim[k]) for k, v in got.items()}
        ok = all(v <= limit for v, limit in numbers.values()) and details["sampled_records"] > 0
        return ok, numbers, details
