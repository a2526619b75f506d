"""The JAX package's four examples (``examples/*.py``), ported: each is a
module with ``main(argv=None)`` that keeps the reference's flags, defaults
and printed lines, adds ``--device`` (default: the card) and runs as
``python -m repro_torch.examples.<name>``."""
