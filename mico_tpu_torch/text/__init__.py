"""Host-side text tokenization."""

from mico_tpu_torch.text.wordpiece import BertWordPieceTokenizer

__all__ = ["BertWordPieceTokenizer"]
