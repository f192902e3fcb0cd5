"""Benchmark clients (the port's ``scripts/benchmarks/``):
``convert_prosody_with_llm``."""
