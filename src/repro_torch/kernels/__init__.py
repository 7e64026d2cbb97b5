"""Hand-written Hopper kernels (``csrc/``), their launches, wrappers and
plain PyTorch versions.

Each kernel has a plain version in `ref`, a launch in `flash_attention`
(built by `build` at first use) and a counting wrapper in `ops`.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
