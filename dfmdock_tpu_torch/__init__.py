"""dfmdock_tpu_torch: the PyTorch/CUDA port of dfmdock_tpu.

Score-based SE(3) diffusion for rigid protein-protein docking (DFMDock's
mlsb lineage): one EGNN predicts the pose scores and the energy that ranks
the poses.  The port mirrors the JAX package module for module; its
inference path runs through hand-written CUDA kernels for Hopper
(`csrc/`, bound in `ops/`).  It imports torch and never JAX.
"""

__version__ = "0.1.0"
