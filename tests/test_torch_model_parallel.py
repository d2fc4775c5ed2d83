"""Model parallelism of the port over 4 gloo ranks on the CPU: the train
step and the train CLI over a (data=2, model=2) `build_mesh`, the reduced
qwen1.5-0.5b and two reduced MoE configs in fp32, global batch 4 x 32.

One module-scoped launch runs `tests/_torch_ranks.py model_parallel`
under `torch.distributed.run` (4 processes, one torch thread each). The
ranks record named checks:
- 3 steps against the one-process step from the same weights and
  batches: loss and grad norm at rtol 1e-5, the first step's gradients at
  relative L2 1e-5 a leaf, parameters at rtol 1e-5 plus 0.1 lr (a step-1
  gradient within its reorder error of AdamW's eps moves a parameter by
  a fraction of lr; ROADMAP.md section 3);
- microbatches 2 against 1 at loss rtol 1e-4;
- a prefill and 3 decode steps over the mesh (caches split on the
  sequence) against one process, logits within 1e-5 of the largest;
- the CLI with --model-parallel 2: 4 steps, then --resume to 8 prints
  "resumed from step 4" on rank 0 only and ends on a checkpoint bitwise
  that of 8 uninterrupted steps; --model-parallel 3 raises ValueError
  before any step;
- a checkpoint moves between a (2, 2) and a (4, 1) mesh bitwise in every
  restored leaf, each restored in the running model's layout;
- two MoE configs in fp32 with two dispatch groups and the default
  capacity factor (tokens are dropped): the reduced qwen2-moe-a2.7b (E=8
  split over "model", a shared expert) and the reduced mixtral-8x22b with
  3 experts (ff split over "model", the sliding window), each held to the
  one-process step, gradients, prefill and decode as above;
- the reduced mamba2-370m's first gradients as above (the SSD scan on
  each rank's slab);
- the CLI with --arch qwen2-moe-a2.7b --reduced --model-parallel 2 (one
  replicated dispatch group, fp32 compute): 3 steps, losses at rtol 1e-5
  of the same CLI in one process.
The one-process step is held to JAX's `make_train_step`
(`tests/test_torch_train.py`); JAX's own train CLI cannot take a step
under its mesh (ROADMAP.md section 3), so the mesh is held to it."""
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
import _torch_ranks as R
from repro_torch.launch.mesh import build_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_parallel_ranks")
    return R.finish(R.launch("model_parallel", out), out, "model_parallel")


def _held(res, *names):
    """Every named check exists and held."""
    for name in names:
        assert f"check.{name}" in res, f"no check {name!r} ran"
        assert bool(res[f"check.{name}"]), str(res[f"detail.{name}"])


def test_mesh_lays_out_params_and_moments(ranks):
    _held(ranks, "mesh_is_data2_model2", "params_and_moments_are_dtensors")


STEP_CHECKS = ["loss_vs_one_process", "grad_norm_vs_one_process", "first_gradients_vs_one_process",
               "params_vs_one_process"]


@pytest.mark.parametrize("check", STEP_CHECKS + [f"{arch}.{c}" for arch in R.MOE_CONFIGS for c in STEP_CHECKS])
def test_step_matches_one_process(ranks, check):
    _held(ranks, check)


@pytest.mark.parametrize("arch", list(R.MOE_CONFIGS))
def test_moe_drops_tokens_and_splits_experts_by_the_rules(ranks, arch):
    """The default capacity factor drops token-expert entries in the
    one-process forward (so the drop set is part of what the mesh step
    matches), and the expert weights are split over "model" on E (8
    experts) or on ff (3 experts), as the parameter rules say."""
    _held(ranks, f"{arch}.capacity_drops_present", f"{arch}.expert_weights_split_as_the_rules_say")


@pytest.mark.parametrize("arch", list(R.MOE_CONFIGS))
def test_moe_prefill_and_decode_match_one_process(ranks, arch):
    """As `test_prefill_and_decode_match_one_process`, on the MoE configs:
    each rank dispatches its own token groups in the prefill and in every
    decode step."""
    _held(ranks, f"{arch}.prefill_and_decode_vs_one_process")


def test_ssm_first_gradients_match_one_process(ranks):
    """The reduced mamba2-370m's first gradients over the mesh at relative
    L2 1e-5 a leaf: the SSD scan runs on each rank's slab, and the inputs
    it shares across ranks that split its output (A over the data ranks, B
    and C over the model ranks) get their gradients summed."""
    _held(ranks, f"{R.SSM_ARCH}.first_gradients_vs_one_process")


def test_moe_cli_matches_one_process(ranks):
    """--arch qwen2-moe-a2.7b --reduced --model-parallel 2: every rank
    exits 0 and the 3 losses are the one-process CLI's at rtol 1e-5 (both
    in fp32 compute; in bf16 the reduction order alone moves the dense
    model's loss by 3e-5)."""
    _held(ranks, "moe_cli_runs_exit_0", "moe_cli_one_process_exit_0", "moe_cli_losses_vs_one_process")


def test_microbatches_two_against_one(ranks):
    _held(ranks, "microbatches_2_vs_1_loss")


def test_prefill_and_decode_match_one_process(ranks):
    """A prefill of 16 tokens, its caches laid out by `cache_pspecs` (the
    sequence split over "model", so each decode step's ring write lands on
    the rank that holds the slot), then 3 greedy decode steps: logits
    within 1e-5 of the largest one and the same tokens as one process."""
    _held(ranks, "prefill_and_decode_vs_one_process")


def test_cli_resume_is_bitwise_uninterrupted(ranks):
    _held(ranks, "cli_runs_exit_0", "cli_resumed_from_step_4_on_rank_0_only", "cli_resume_bitwise_uninterrupted")


def test_cli_refuses_model_parallel_not_dividing_the_world(ranks):
    _held(ranks, "cli_model_parallel_3_on_4_ranks_raises_before_a_step")


def test_checkpoint_moves_between_mesh_shapes(ranks):
    _held(ranks, "ckpt_mp2_restores_under_mp1_bitwise", "ckpt_mp1_restores_under_mp2_bitwise",
          "restored_leaves_take_the_running_layout")


def test_ranks_import_neither_jax_nor_repro(ranks):
    _held(ranks, "ranks_import_neither_jax_nor_repro")


def test_build_mesh_needs_a_group_and_a_divisor():
    """One process is a world of one rank: --model-parallel 2 does not
    divide it, and a mesh of it needs a process group it never starts."""
    with pytest.raises(ValueError, match="does not divide"):
        build_mesh(2, "cpu")
    with pytest.raises(ValueError, match="process group"):
        build_mesh(1, "cpu")
