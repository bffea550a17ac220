"""Nucleotide encoding of the port (copy of ``blasr_tpu/core``)."""
