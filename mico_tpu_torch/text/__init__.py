"""Host-side text tokenization: BERT's WordPiece, CLIP's byte-level BPE
(`text.bpe`) and the HF tokenizer bridge (`text.hf_adapter`)."""

from mico_tpu_torch.text.wordpiece import BertWordPieceTokenizer

__all__ = ["BertWordPieceTokenizer"]
