"""Serving: KV cache, engine, continuous-batching scheduler, load generator."""
