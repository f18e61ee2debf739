# The port's training step and optimizer (the JAX package's train/ has no package file).
