# The port's synthetic training data (the JAX package's data/ has no package file).
