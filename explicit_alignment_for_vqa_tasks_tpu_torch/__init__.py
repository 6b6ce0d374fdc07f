"""PyTorch/CUDA port of explicit_alignment_for_vqa_tasks_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here keeps
the name of its JAX counterpart so that each can be found there. This
package imports ``torch`` and ``numpy`` only: never ``jax`` and never the
JAX package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; a kernel wrapper uses its plain PyTorch version only for
tensors that lie on the CPU.
"""
