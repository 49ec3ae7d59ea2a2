"""Device-mesh scaling: sharded acquisition and channel-sharded tracking
(torch port of the JAX package's parallel/)."""
