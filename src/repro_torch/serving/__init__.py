"""RAG serving: the sequential engines and the latency model."""
