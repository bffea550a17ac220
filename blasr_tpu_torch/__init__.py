"""blasr_tpu_torch — the BLASR-capability long-read aligner in PyTorch.

The port of ``blasr_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA
kernels for one NVIDIA H100. It imports neither JAX nor anything of
``blasr_tpu``: the host modules it needs are its own copies, laid out as
in the JAX package:

  params.py  MappingParams
  core/      nucleotide encoding
  io/        FASTA, FASTQ and SAM input, read batching
  index/     suffix-array genome index
  native.py  C++ host helpers (csrc/host_native.cpp) and their plain versions
  sim.py     read simulator
  ops/       anchoring, candidates, banded DP, traceback walk, MAPQ
  csrc/      CUDA kernels (banded DP, span/row gathers), built at first use
  pipeline/  per-batch mapping step and the host run loop
  output/    -m 4 records
  cli/       ``python -m blasr_tpu_torch.cli.blasr``
  interop.py the JAX device index carried across as numpy arrays
"""

__version__ = "0.2.0"
