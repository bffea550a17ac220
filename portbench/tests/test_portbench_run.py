"""The harness end to end on the CPU, past its look for a chip: a dummy
cell added from new files alone (a configuration, a traffic mix and a
check beside copies of the others), its result line's keys in plain and
traced runs, the no-JAX check after the runs, the control found not
correct, and each fault the cells can have found not correct: half of
the reads' answers left out, half of them reported unmapped, and every
answer altered where run_mapping produces it. A mapper holds no state across steps and these cells run
on one chip, so the faults of a step that returns its state unchanged
and of a missing exchange between chips do not arise."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "tiny_m4.tiny"
SAM_CELL = "tiny_sam.tinyq"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def dummy_root(tmp_path_factory):
    """A copy of the benchmark with one more cell, from new files alone."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_m4", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_m4.json", "reduced": [],
                             "why": "a 60 kb genome for the CPU"})
    bench["workloads"].append({"name": CELL, "config": "tiny_m4", "traffic": "tiny",
                               "chips": 1, "why": "two chunks of 12 short reads"})
    bench["configs"].append({"name": "tiny_sam", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_sam.json", "reduced": [],
                             "why": "the SAM path on a 60 kb genome"})
    bench["workloads"].append({"name": SAM_CELL, "config": "tiny_sam", "traffic": "tinyq",
                               "chips": 1, "why": "two chunks of 16 short FASTQ reads"})
    for m in bench["per_layer"]:
        m["workloads"] += [CELL, SAM_CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "ecoli_m4.json").read_text())
    conf.update(name="tiny_m4",
                flags=["-m", "4", "-bestn", "1", "-maxReadLen", "1024", "-batchSize", "8",
                       "-minMatch", "12"],
                genome={"name": "tiny", "length": 60_000, "seed": 3, "repeat_fraction": 0.05})
    (pb / "configs" / "tiny_m4.json").write_text(json.dumps(conf))
    (pb / "traffic" / "tiny.json").write_text(json.dumps({
        "generator": "simulate_reads", "format": "fasta", "tag": "sim", "mean_len": 250,
        "min_len": 150, "sub_rate": 0.01, "ins_rate": 0.08, "del_rate": 0.04,
        "length_seed": 5, "chunk_reads": 12, "pool_chunks": 2, "warmup_reads": 4}))
    # a dozen reads of 150-400 bp: up to a third fall under the mapping
    # filters and are reported unmapped, so the fixture's placement limit
    # is its own (sound runs read 0 and 33%, half the reads unmapped 50%+)
    check = json.loads((pb / "checks" / "ecoli_m4.fasta_1k.json").read_text())
    check["limits"]["locus_off_pct"] = 40.0
    (pb / "checks" / f"{CELL}.json").write_text(json.dumps(check))
    conf = json.loads((pb / "configs" / "ecoli_sam.json").read_text())
    flags = conf["flags"]
    flags[flags.index("-maxReadLen") + 1] = "1024"
    flags[flags.index("-batchSize") + 1] = "8"
    conf.update(name="tiny_sam", flags=flags + ["-minMatch", "12"],
                genome={"name": "tiny", "length": 60_000, "seed": 3, "repeat_fraction": 0.05})
    (pb / "configs" / "tiny_sam.json").write_text(json.dumps(conf))
    traffic = json.loads((pb / "traffic" / "ccs_fastq.json").read_text())
    del traffic["chunk_batches"]
    traffic.update(lengths=[200, 300, 400, 600], length_probs=[0.25] * 4, chunk_reads=16,
                   warmup_reads=4)
    (pb / "traffic" / "tinyq.json").write_text(json.dumps(traffic))
    check["limits"]["path_off"] = 0
    (pb / "checks" / f"{SAM_CELL}.json").write_text(json.dumps(check))
    return root


def _drive(root, cell, *modes):
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "tests" / "dry_driver.py"),
         str(root), cell, *modes],
        capture_output=True, text=True, env=_env(), cwd=root, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: v if k == "loaded" else v[0] for k, v in res.items()}


@pytest.fixture(scope="module")
def runs(dummy_root):
    return _drive(dummy_root, CELL, "plain", "trace", "control", "drop_half", "unmapped_half",
                  "alter")


@pytest.fixture(scope="module")
def sam_runs(dummy_root):
    return _drive(dummy_root, SAM_CELL, "plain", "control")


def test_result_line_keys(runs):
    r = runs["plain"]
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["metrics"]) == {"bases_per_s", "true_locus_pct", "peak_device_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 12
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_traced_result_line(runs):
    r = runs["trace"]
    assert list(r)[-1] == "checks" and r["correct"] is True
    # the CPU run has no device trace: those readers return nothing
    assert {"setup.index_s", "runner.finalize_pct", "passes.escalated_per_kread",
            "step.front_pct", "step.walk_pct", "output.write_pct"} <= set(r["metrics"])
    assert "banded_dp_roofline" not in r["metrics"] and "bases_per_s" not in r["metrics"]


def test_no_jax_after_the_runs(runs):
    assert runs["loaded"] == []


def test_control_is_not_correct(runs):
    r = runs["control"]
    assert r["correct"] is False
    assert r["checks"]["score_off_pct"]["value"] > r["checks"]["score_off_pct"]["limit"]


def test_locus_check_reads_the_true_locus_share(runs):
    # the check reads the written text, the metric the program's records:
    # on m4 lines with one record a read they agree
    r = runs["plain"]
    assert r["checks"]["locus_off_pct"]["value"] == pytest.approx(
        100.0 - r["metrics"]["true_locus_pct"]["value"])


@pytest.mark.parametrize("fault, number", [("drop_half", "missing_reads"),
                                           ("unmapped_half", "locus_off_pct"),
                                           ("alter", "score_off_pct")])
def test_faults_are_not_correct(runs, fault, number):
    r = runs[fault]
    assert r["correct"] is False
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
    if fault == "unmapped_half":
        # the fault every other number lets through
        others = {k: c for k, c in r["checks"].items() if k != number}
        assert all(c["value"] <= c["limit"] for c in others.values())


def test_sam_cell(sam_runs):
    # the SAM path: FASTQ reads, phred-scaled scoring, CIGAR and SEQ held
    # to the reads and the genome (path_off), the control found not correct
    r = sam_runs["plain"]
    assert r["correct"] is True and set(r["checks"]) >= {"locus_off_pct", "path_off"}
    assert r["checks"]["path_off"]["value"] == 0
    c = sam_runs["control"]
    assert c["correct"] is False and c["checks"]["path_off"]["value"] > 0


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ecoli_m4.fasta_1k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ecoli_m4.fasta_1k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
