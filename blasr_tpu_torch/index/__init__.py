"""The suffix-array genome index of the port (copies of the modules of
``blasr_tpu/index`` that the port calls)."""
