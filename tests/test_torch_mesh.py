"""The port's fleet mesh against the JAX package's sharded-fleet contract
(`tests/test_sharded_fleet.py`), over 4 gloo ranks on the CPU.

One module-scoped launch runs `tests/_torch_ranks.py fleet` under
`torch.distributed.run` (4 processes, one torch thread each): every rank
solves the same mixed-size pool with `solve_fleet(shard=True)`, rank 0
also solves it unsharded, and the ranks record named checks. Meanwhile
this process solves the pool once with JAX's unsharded `solve_fleet`, which
holds the port at rtol 1e-5. A rank that fails fails every test here."""
import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
import _torch_ranks as R
from repro import core as J
from repro.fleet import METHODS, solve_fleet as j_solve_fleet


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet_ranks")
    proc = R.launch("fleet", out)
    try:
        jax_kw = {k: v for k, v in R.SOLVE_KW.items() if k != "device"}
        jres = j_solve_fleet(R.fleet_pool(J, device=None), method="ALT", **jax_kw)
    finally:
        res = R.finish(proc, out, "fleet")
    return res, jres


def _held(res, *names):
    """Every named check (a name ending in "_" covers its prefix) exists
    and held."""
    checks = [k[len("check."):] for k in res if k.startswith("check.")]
    for name in names:
        hit = [c for c in checks if (c.startswith(name) if name.endswith("_") else c == name)]
        assert hit, f"no check {name!r} ran"
        bad = {c: str(res["detail." + c]) for c in hit if not bool(res["check." + c])}
        assert not bad, bad


@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_unsharded(ranks, method):
    """J / J_comm / J_comp / history at rtol 1e-5, iters, hosts and rounds
    equal, over a 4-rank mesh with the plan saying so."""
    res, _ = ranks
    _held(res, f"sharded_{method}_")
    assert str(res[f"sharded_{method}.reason"]) == "sharded"
    assert res[f"sharded_{method}.plan"].tolist() == [4, 8, 8, 1]


def test_sharded_matches_jax(ranks):
    res, jres = ranks
    for f in ("J", "J_comm", "J_comp", "history"):
        np.testing.assert_allclose(res[f"sharded_ALT.{f}"], np.asarray(getattr(jres, f)), rtol=1e-5)
    np.testing.assert_array_equal(res["sharded_ALT.iters"], np.asarray(jres.iters))
    # Every host is compared: no decision of this pool sits within move_margin.
    np.testing.assert_array_equal(res["sharded_ALT.hosts"], np.asarray(jres.hosts))
    assert int(res["sharded_ALT.rounds"]) == jres.rounds


def test_non_divisible_batch_pads_and_trims(ranks):
    """B=10 over 4 ranks pads to 12 with inert repeats and trims to 10."""
    res, _ = ranks
    _held(res, "pad10_")
    assert res["pad10.plan"].tolist() == [4, 10, 12, 1] and res["pad10.J"].shape == (10,)


def test_chunked_and_sharded_compose(ranks):
    """chunk_size=3 rounds up to a rank multiple; every chunk stays laid out."""
    res, _ = ranks
    _held(res, "chunked_")


def test_pads_and_repeats_bitwise_inert(ranks):
    """Tail repeats (6 -> 8 lanes), a phantom instance, a rotation that moves
    instances across ranks and a mesh of the first 2 ranks leave the real
    lanes' J and hosts bitwise unchanged."""
    res, _ = ranks
    _held(res, "tail_repeats_bitwise_inert", "phantom_bitwise_inert", "rotation_across_ranks_bitwise",
          "submesh_of_two_ranks")


def test_outputs_carry_fleet_sharding(ranks):
    res, _ = ranks
    _held(res, "shard_fleet_leaves_are_dtensors", "carries_fleet_sharding_accepts_the_fleet_layout",
          "fleet_sharding_needs_a_fleet_dim")
    assert all(res[f"{c}.plan"][3] == 1 for c in ("sharded_ALT", "pad10", "chunked", "submesh"))


def test_to_named_shardings(ranks):
    """Spec tuples (an axis, None, a tuple of axes, ()) as DTensor
    placements over a (2, 2) ("data", "model") mesh."""
    _held(ranks[0], "to_named_shardings")


@pytest.mark.parametrize("case", ["a_plain_tensor", "a_one_rank_mesh", "replicate"])
def test_carries_fleet_sharding_rejects(ranks, case):
    _held(ranks[0], f"carries_fleet_sharding_rejects_{case}")


def test_one_rank_plan_is_single_device_and_logged(ranks):
    _held(ranks[0], "one_rank_plan_is_single_device_and_logged")


def test_lane_chunk_with_a_mesh_raises(ranks):
    _held(ranks[0], "lane_chunk_with_a_mesh_raises")


def test_mesh_wider_than_the_world_raises(ranks):
    _held(ranks[0], "mesh_wider_than_the_world_raises", "devices_wider_than_the_world_raises")


def test_run_control_sharded_matches_unsharded(ranks):
    """2 instances x 3 fault epochs (cold, then warm starts over the mesh)."""
    res, _ = ranks
    _held(res, "control_")
    assert int(res["control.events"]) > 0


def test_every_rank_returns_one_result(ranks):
    """The gather gives every rank the same result, the trace has one
    length, and the ranks never load JAX."""
    _held(ranks[0], "same_result_on_every_rank", "trace_one_length", "ranks_import_neither_jax_nor_repro")


def test_every_check_held_and_against_reference(ranks):
    """No check failed, and the numbers match those committed from a run of
    the same ranks (the reference `chip_smoke.py` holds the GPU machine's
    host to)."""
    res, _ = ranks
    assert not R.failed_checks(res)
    err = R.against_reference("fleet", res)
    assert all(e <= 1e-5 for e in err.values()), err
