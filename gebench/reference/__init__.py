"""The plain reference that decides `correct`: one generation of the
GeneEvolve forward simulation in plain NumPy and PyTorch, from the
scenario files and a parent state. It imports nothing of the program."""
