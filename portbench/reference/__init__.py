"""The plain reference the check holds the program's output to: NumPy and
PyTorch only, nothing of the program (``align.py``), and the parsers of
the output formats the program writes (``outputs.py``)."""
