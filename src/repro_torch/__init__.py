"""PyTorch port of the serve path of `repro` for NVIDIA Hopper.

The JAX package (`src/repro/`) is the reference this package is checked
against; nothing here imports it. Module paths and names mirror it so each
module's counterpart is easy to find.
"""
