"""Batched and sharded datagen (``batch``) and the process group and device
mesh it shards over (``distributed``). Like the JAX package's
``parallel``, the package itself exports nothing."""
