"""PyTorch / CUDA port of canonicalvoting_tpu for the NVIDIA H100.

The joint inference path: host voxelization and dense prep, the dense
MinkUNet34C on hand-written occupied-tile CUDA kernels, the objectness vote
splat kernel, on-device box peeling, host NMS and Scan2CAD mAP. Importing the
package builds nothing; the CUDA sources in ``csrc/`` are compiled on first
use (``ops/cuda_build.py``).
"""
