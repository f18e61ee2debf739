"""The JAX package's ``examples/`` scripts as the port's entry points.

Each runs as ``python -m repro_torch.examples.<name>`` with the JAX
script's arguments and printed lines, plus ``--device`` (default: the
CUDA card; ``--device cpu`` for the CPU).  Where a JAX script simulates
with the sequential engine (``sim.engine.simulate``), its port replays
the same trace through ``core.batched.replay`` on the device: the two
engines give the same decisions.
"""
