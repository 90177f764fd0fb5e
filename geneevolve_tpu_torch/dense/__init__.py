"""Dense genome engines in PyTorch: the byte step (`step.py`), the
bit-packed step (`packed.py`) and the `--backend dense` scenario runner
(`backend.py`)."""
