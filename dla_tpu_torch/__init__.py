"""dla_tpu_torch: the PyTorch/CUDA port of dla_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference (``dla_tpu``), which it
never imports. Its modules mirror ``dla_tpu``'s layout and names; the
Pallas TPU kernels on a ported path become hand-written CUDA kernels
under ``csrc/``, each with a plain PyTorch version beside its wrapper.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper computes its plain version.

Ported so far: the int8 RLHF rollout generation path (contiguous-KV
``generation.engine.build_generate_fn`` on llama-family models), with
kernels for flash-attention forward, decode attention and the int8
weight-only matmul. ROADMAP.md lists what follows.
"""
