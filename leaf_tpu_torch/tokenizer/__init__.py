"""Host-side CLIP byte-BPE tokenizer of the port (stdlib `re`, no native
path)."""
from leaf_tpu_torch.tokenizer.bpe import CLIPTokenizer, get_tokenizer

__all__ = ["CLIPTokenizer", "get_tokenizer"]
