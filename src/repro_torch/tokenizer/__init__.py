"""Copied from ``src/repro/tokenizer/__init__.py``, with its imports
rewritten to ``repro_torch``."""
from repro_torch.tokenizer.bpe import BPETokenizer, train_bpe
from repro_torch.tokenizer.pool import TokenizerPool

__all__ = ["BPETokenizer", "train_bpe", "TokenizerPool"]
