"""Serving: KV cache, engine, continuous-batching scheduler, load generator,
and the fleet: a replica process and the router in front of replicas."""
