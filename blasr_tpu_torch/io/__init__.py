"""Read and genome input of the port: FASTA, FASTQ, SAM and read batching
(copies of the modules of ``blasr_tpu/io`` that the port calls)."""
