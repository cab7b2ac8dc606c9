"""Attention without the kernels: the plain reference and the blockwise
scan (counterparts of deeplearning4j_tpu/parallel/)."""
