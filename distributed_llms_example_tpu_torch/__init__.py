"""PyTorch/CUDA port of ``distributed_llms_example_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
subpackage and module names so a reader can find each counterpart, and it
imports nothing of it (nor JAX): what it needs from there it keeps as its
own copy.  The TPU's Pallas kernels on the ported path are hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_build.py``).

Ported so far: serving and fine-tuning T5 and BART, serving LLaMA from a
flat or a paged KV cache (``launch/cli.py``), with all eight TPU kernels
as CUDA kernels: flash-attention forward, its dq, dk/dv and learned-bias
gradient backward (each with its attention-probs dropout branch), flash
decode flat and paged, fused residual dropout and fused AdamW; models
load from and save to local HF checkpoint directories; the trainer
evaluates (beam search, ROUGE), checkpoints and resumes, and recovers
from anomalies in-process.  ROADMAP.md lists what is still to come.
"""
