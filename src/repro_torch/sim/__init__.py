# Cluster objects and result metrics (copies of the JAX package's).
