"""The plain reference the benchmark judges the program's answers with
(`judge.py`). Plain PyTorch and NumPy; it imports nothing of the program."""
