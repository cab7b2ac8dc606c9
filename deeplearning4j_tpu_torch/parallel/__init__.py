"""Attention without the kernels (the plain reference and the blockwise
scan), sequence-parallel ring attention over a device mesh, and the mesh
(counterparts of deeplearning4j_tpu/parallel/)."""
