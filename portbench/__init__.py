"""The PyTorch/CUDA port's benchmark: ``run.py`` runs one cell once."""
