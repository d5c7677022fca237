"""Retrieval substrate: flat exact search, the IVF fuzzy index, the hashed
lexical terms of the world, and the RetrievalService."""
