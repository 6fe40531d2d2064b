"""Benchmark vocabularies; the semantic steps themselves wait for ROADMAP A8."""

from maskclustering_tpu_torch.semantics.vocab import get_vocab, vocab_name

__all__ = ["get_vocab", "vocab_name"]
