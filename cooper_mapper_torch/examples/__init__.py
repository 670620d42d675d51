"""The user scripts of the port (ports of the JAX package's ``examples/``):
each module runs as ``python -m cooper_mapper_torch.examples.<name>``."""
