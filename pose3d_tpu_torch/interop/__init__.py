"""Weight conversion: the JAX package's flax trees -> the port's state
dicts (``weights.py``), and the reference repository's checkpoints <-> the
port's state dicts (``torch_weights.py``)."""
