"""PyTorch/CUDA port of cosypose_tpu's render-and-compare pose inference.

A second package beside the JAX reference (`cosypose_tpu/`), with the same
layout (`ops/`, `models/`, `integrated/`, `utils/`) so every counterpart is
easy to find, plus `csrc/` for the hand-written Hopper kernel. It imports
torch and numpy only — never jax, flax or the JAX package.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU; with no card present they raise instead of falling back.
"""

__version__ = "0.1.0"
