"""Microbenchmarks of kernel design choices on the card (counterparts of
the JAX package's TPU probes under ``tools/``)."""
