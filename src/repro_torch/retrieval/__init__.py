"""Retrieval substrate: flat exact search, the IVF index (f32 and int8
residual codes), the hashed lexical channel, the hybrid cloud stage
(fusion.py), and the RetrievalService with its backends."""
