"""Data: the synthetic entity-attribute RAG world."""
