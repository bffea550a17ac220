"""On the card: the dummy cell's run through the CUDA kernels, correct,
and its control not correct (``python -m pytest portbench/tests -m cuda``
on a machine with an H100)."""

import json
import subprocess
import sys

import pytest

from test_portbench_run import CELL, _env, dummy_root  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def test_dummy_cell_on_the_card(cuda_device, dummy_root):  # noqa: F811
    code = (
        "import sys, json, time; sys.path.insert(0, %r)\n"
        "import portbench.run as R\n"
        "from portbench.harness.cell import CellRun\n"
        "from portbench.harness.spec import Bench\n"
        "out = {}\n"
        "for ctrl in (False, True):\n"
        "    t0 = time.perf_counter()\n"
        "    run = CellRun(Bench(%r), %r, t0, control=ctrl)\n"
        "    run.setup()\n"
        "    out[str(ctrl)] = R.run_seed(run, 2**31 + 99, 0.5, False, t0)\n"
        "print(json.dumps(out))\n" % (str(dummy_root), CELL, cuda_device))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=dummy_root, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["False"]["correct"] is True and res["False"]["device"]["platform"] == "gpu"
    assert res["True"]["correct"] is False
