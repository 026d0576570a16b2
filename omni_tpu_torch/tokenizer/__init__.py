from .vocab import Tokenizer, Vocab, build_tokenizer, vocab_from_gguf

__all__ = ["Tokenizer", "Vocab", "build_tokenizer", "vocab_from_gguf"]
