"""PPO-RLHF CLI variants against the JAX package's CLI (the setup of
tests/test_torch_rlhf.py, 2 rollouts a run): G = 2 samples per prompt,
int8 rollout weights, a run interrupted and resumed, and the
checkpoints the chained phases read."""
import numpy as np
import pytest
import torch

from dla_tpu_torch.checkpoint.checkpointer import resolve_checkpoint_dir
from dla_tpu_torch.training import train_rlhf
from dla_tpu_torch.training.model_io import load_causal_lm
from dla_tpu_torch.training.trainer import _leaves
from test_torch_rlhf import (
    assert_rollouts_match,
    reward_checkpoint,
    rlhf_argv,
    run_both,
    write_prompts,
)


def test_rlhf_cli_group_of_two_matches_jax(tmp_path, monkeypatch):
    """samples_per_prompt 2: 4 prompts a rollout, each prefilled once and
    sampled twice (grouped rows), tokens and train/* values as JAX's."""
    jrows, trows, jseqs, tseqs, _ = run_both(
        tmp_path, monkeypatch, "reinforce", steps=2,
        **{"ppo.samples_per_prompt": 2})
    assert_rollouts_match(jrows, trows, jseqs, tseqs, 2)
    for seqs in tseqs:   # the two rows of a prompt start alike
        assert (seqs[0::2, :8] == seqs[1::2, :8]).all()


@pytest.mark.parametrize("algo", ["reinforce", "gae"])
def test_rlhf_cli_quantized_rollout_matches_jax(tmp_path, monkeypatch,
                                                algo):
    """ppo.rollout_quantize_weights: the rollout samples and scores from
    the int8 weight-only tree (int8 matmul kernel's plain version here),
    the update trains the fp32 policy; equal tokens, train/* to 1e-5.
    The JAX package consumes int8 weights through its Pallas kernel
    (bf16 activations) on one chip and through an XLA dequant path (fp32
    activations) under a multi-device mesh; its mesh check is made to
    see one device, so the JAX run goes through the kernel (interpret
    mode), the function the port's kernel computes."""
    import dla_tpu.models.transformer as j_transformer
    monkeypatch.setattr(j_transformer, "_flash_mesh", lambda: None)
    jrows, trows, jseqs, tseqs, trainer = run_both(
        tmp_path, monkeypatch, algo, steps=2,
        **{"ppo.rollout_quantize_weights": "true"})
    assert_rollouts_match(jrows, trows, jseqs, tseqs, 2)
    params = trainer.params["policy"] if algo == "gae" else trainer.params
    assert params["layers"]["wq"].dtype == torch.float32


def test_rlhf_cli_resume_matches_jax(tmp_path, monkeypatch):
    """ppo stopped after 1 rollout (its final checkpoint) and resumed to 2
    with --resume, in both packages: the resumed run starts at rollout 2
    (step 3 of 2 minibatches a rollout) and logs what the JAX run resumed
    the same way logs."""
    jrows, trows, jseqs, tseqs, trainer = run_both(
        tmp_path, monkeypatch, "ppo", steps=2, resume_at=1)
    assert [r["step"] for r in trows] == [1, 2]
    assert trainer.step == 4
    assert_rollouts_match(jrows, trows, jseqs, tseqs, 2)


def test_rlhf_gae_checkpoints_chain(tmp_path, monkeypatch):
    """gae writes the {policy, value_head} training tree as ``final`` and
    a plain-policy checkpoint ``policy`` that ``latest`` names: the next
    phase loads it as a causal LM equal to the trained policy; ``final``
    holds the trained value head."""
    monkeypatch.chdir(tmp_path)
    reward_checkpoint(tmp_path / "reward")
    write_prompts(tmp_path / "prompts.jsonl")
    trainer = train_rlhf.main(rlhf_argv(tmp_path, "t_gae", "gae", 2),
                              device="cpu")
    ckpt = tmp_path / "t_gae" / "ckpt"
    assert resolve_checkpoint_dir(ckpt / "latest").name == "policy"
    back = load_causal_lm(str(ckpt / "latest"), {}, device="cpu")
    mine = trainer.params["policy"]
    for key in ("final_norm", "lm_head"):
        assert torch.equal(back.params[key], mine[key].detach())
    for key, val in mine["layers"].items():
        assert torch.equal(back.params["layers"][key], val.detach()), key
    from dla_tpu_torch.checkpoint.checkpointer import load_tree_numpy
    final, aux = load_tree_numpy(str(ckpt / "final"), prefix="params")
    assert aux["step"] == trainer.step == 4
    np.testing.assert_array_equal(
        final["value_head"]["w"],
        trainer.params["value_head"]["w"].detach().numpy())
    assert np.abs(final["value_head"]["w"]).sum() > 0
    assert len(_leaves(trainer.train_params)) == len(trainer.leaves)


def test_rlhf_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reward_checkpoint(tmp_path / "reward")
    write_prompts(tmp_path / "prompts.jsonl")
    for sets, match in ((("ppo.rollout.backend", "serving"), "serving"),
                        (("ppo.rollout.mode", "async"), "async"),
                        (("ppo.rollout.fleet", "{samplers: 2}"), "fleet"),
                        (("model.lora", "{enabled: true}"), "LoRA")):
        argv = rlhf_argv(tmp_path, "x", "reinforce", 1) + [
            "--set", f"{sets[0]}={sets[1]}"]
        with pytest.raises(NotImplementedError, match=match):
            train_rlhf.main(argv, device="cpu")
