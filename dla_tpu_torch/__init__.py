"""dla_tpu_torch: the PyTorch/CUDA port of dla_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference (``dla_tpu``), which it
never imports. Its modules mirror ``dla_tpu``'s layout and names; the
Pallas TPU kernels on a ported path become hand-written CUDA kernels
under ``csrc/``, each with a plain PyTorch version beside its wrapper.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper computes its plain version.

Ported so far: rollout generation (contiguous-KV
``generation.engine.build_generate_fn``, sampling ``jax.random``'s
tokens through ``ops.prng``), SFT, the reward model, DPO, PPO-RLHF and
distillation, with kernels for flash attention (forward and backward),
decode attention, the int8 weight-only matmul and the categorical draw.
ROADMAP.md lists what follows.
"""
