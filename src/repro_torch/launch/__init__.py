# The port's command-line entry points and checkpointing (the JAX package's launch/ has no package file).
