"""Host-side CLIP byte-BPE tokenizer of the port (stdlib `re`; a native
C++ fast path for ASCII text, built at first use)."""
from leaf_tpu_torch.tokenizer.bpe import CLIPTokenizer, get_tokenizer

__all__ = ["CLIPTokenizer", "get_tokenizer"]
