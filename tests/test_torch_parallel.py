"""The port's `parallel/` and `stark/pipeline.py` against the JAX package.

Every comparison is exact. The sharded functions run on a logical 8-shard
CPU mesh (`make_mesh(8, devices=["cpu"] * 8)`), on the same numpy inputs
from a seed as the cases of the reference's `tests/test_sharded.py`, and
are held to the port's single-device functions and the reference's (its
host path). Under `slow` they are also held to the reference's sharded
functions on its 8 forced host devices (`tests/conftest.py`), whose XLA
compiles take 17-96 s apiece here and an hour with the sharded core;
those results are built once, in one module fixture. `make_prover_core` equals the reference's jitted core (at
2^3 rows: about 50 s of compile here), and the sharded core equals
`make_prover_core` on 8 and 2 shards. `ProvingPool` keeps the reference's
cases (`test_task_roundtrip`; `test_pool_matches_sequential` under `slow`).
Entry points given no device raise on a host with no card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_prover_tpu.fields import babybear as ref_bb
from zkvm_prover_tpu.models.fibonacci import FibonacciAir as RefFibonacciAir
from zkvm_prover_tpu.ops import ntt as ref_ntt
from zkvm_prover_tpu.parallel import mesh as ref_mesh
from zkvm_prover_tpu.parallel.fri_sharded import fold_round_sharded as ref_fold_sharded
from zkvm_prover_tpu.parallel.merkle_sharded import commit_root_sharded as ref_root_sharded
from zkvm_prover_tpu.parallel import ntt_sharded as ref_ns
from zkvm_prover_tpu.parallel.pipeline_sharded import (
    eval_poly_at_point_ext_sharded as ref_ood_sharded,
    make_prover_core_sharded as ref_core_sharded,
)
from zkvm_prover_tpu.stark import fri as ref_fri
from zkvm_prover_tpu.stark import merkle as ref_merkle
from zkvm_prover_tpu.stark.config import StarkConfig as RefStarkConfig
from zkvm_prover_tpu.stark.pipeline import make_prover_core as ref_make_core
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask, UniversalVerifier
from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
from zkvm_prover_tpu_torch.ops import ntt
from zkvm_prover_tpu_torch.parallel import mesh
from zkvm_prover_tpu_torch.parallel import ntt_sharded as ns
from zkvm_prover_tpu_torch.parallel.fri_sharded import fold_round_sharded
from zkvm_prover_tpu_torch.parallel.merkle_sharded import commit_root_sharded
from zkvm_prover_tpu_torch.parallel.pipeline_sharded import (
    eval_poly_at_point_ext_sharded,
    eval_poly_at_points_ext_sharded,
    make_prover_core_sharded,
)
from zkvm_prover_tpu_torch.parallel.pool import ProvingPool
from zkvm_prover_tpu_torch.stark import fri, merkle
from zkvm_prover_tpu_torch.stark.config import StarkConfig, fast_test_config
from zkvm_prover_tpu_torch.stark.pipeline import make_prover_core

P = bb.P


def no_card():
    """Skip a check of the behaviour of a host with no card where there is one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host with no card")


def _rand(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _monty(a):
    return bb.to_monty_np(np.asarray(a, dtype=np.uint64))


def _t(a):
    return bb.as_tensor(a, "cpu")


def _np(x):
    if isinstance(x, mesh.Sharded):
        x = x.gather()
    return bb.to_numpy(x)


# (name, numpy input in Montgomery form, extra arguments): the cases of the
# reference's test_sharded.py
INPUTS = {
    "ntt": _monty(_rand(1, (1 << 10,))),
    "ntt_batched": _monty(_rand(2, (1 << 8, 3))),
    "merkle": _monty(_rand(3, (64, 5))),
    "intt": _monty(_rand(4, (1 << 9, 2))),
    "lde": _monty(_rand(5, (1 << 8, 3))),
    "fold": _monty(_rand(6, (1 << 9, 4))),
    "beta": _monty(_rand(7, (4,))),
    "ood": _monty(_rand(8, (1 << 9, 3))),
    "z": _monty(_rand(9, (4,))),
    "core_challenges": [_monty(_rand(10 + i, (4,))) for i in range(3)],
}
CORE_LOG_N = 8


def _core_inputs():
    trace, pvs = FibonacciAir().generate_trace(CORE_LOG_N)
    return (_monty(trace), np.array([bb.to_monty_int(v) for v in pvs], dtype=np.uint32))


@pytest.fixture(scope="module")
def mesh8():
    return mesh.make_mesh(n_shard=8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded results over its 8 forced host devices (XLA
    compiles each: 17-80 s apiece here, so only `slow` cases use them)."""
    assert jax.device_count() >= 8, "conftest must force 8 host devices"
    m8 = ref_mesh.make_mesh(n_shard=8)
    j = {k: jnp.asarray(v) for k, v in INPUTS.items() if k != "core_challenges"}
    out = {
        "ntt": ref_ns.ntt_natural_to_rev_sharded(j["ntt"], m8),
        "ntt_batched": ref_ns.ntt_natural_to_rev_sharded(j["ntt_batched"], m8),
        "merkle": ref_root_sharded(j["merkle"], m8),
        "intt": ref_ns.intt_natural_to_rev_sharded(j["intt"], m8),
        "rev_to_natural": ref_ns.ntt_rev_to_natural_sharded(j["intt"], m8),
        "lde": ref_ns.coset_lde_sharded(j["lde"], 1, m8),
        "fold": ref_fold_sharded(j["fold"], 9, ref_bb.GENERATOR, j["beta"], m8),
        "ood": ref_ood_sharded(j["ood"], j["z"], m8),
    }
    out["fold2"] = ref_fold_sharded(jnp.asarray(np.asarray(out["fold"])), 8,
                                    ref_bb.GENERATOR ** 2 % P, j["beta"], m8)
    trace_m, pvs_m = _core_inputs()
    core = ref_core_sharded(RefFibonacciAir(), CORE_LOG_N, RefStarkConfig(), m8)
    out["core"] = core(jnp.asarray(trace_m), jnp.asarray(pvs_m),
                       *(jnp.asarray(c) for c in INPUTS["core_challenges"]))
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in out.items()}


def _port_sharded(m8):
    """The port's sharded results on its logical 8-shard CPU mesh."""
    t = {k: _t(v) for k, v in INPUTS.items() if k != "core_challenges"}
    out = {
        "ntt": ns.ntt_natural_to_rev_sharded(t["ntt"], m8),
        "ntt_batched": ns.ntt_natural_to_rev_sharded(t["ntt_batched"], m8),
        "merkle": commit_root_sharded(t["merkle"], m8),
        "intt": ns.intt_natural_to_rev_sharded(t["intt"], m8),
        "rev_to_natural": ns.ntt_rev_to_natural_sharded(t["intt"], m8),
        "lde": ns.coset_lde_sharded(t["lde"], 1, m8),
        "fold": fold_round_sharded(t["fold"], 9, bb.GENERATOR, t["beta"], m8),
        "ood": eval_poly_at_point_ext_sharded(t["ood"], t["z"], m8),
    }
    out["fold2"] = fold_round_sharded(out["fold"], 8, bb.GENERATOR ** 2 % P, t["beta"], m8)
    trace_m, pvs_m = _core_inputs()
    core = make_prover_core_sharded(FibonacciAir(), CORE_LOG_N, StarkConfig(), m8)
    out["core"] = core(_t(trace_m), pvs_m, *INPUTS["core_challenges"])
    return {k: (tuple(_np(x) for x in v) if isinstance(v, tuple) else _np(v))
            for k, v in out.items()}


@pytest.fixture(scope="module")
def port_sharded(mesh8):
    return _port_sharded(mesh8)


@pytest.fixture(scope="module")
def ref_single():
    """The reference's single-device functions on numpy inputs (its host
    path: no XLA compile)."""
    i = INPUTS
    fold = ref_fri.fold_round(i["fold"], 9, ref_bb.GENERATOR, i["beta"])
    return {
        "ntt": np.asarray(ref_ntt.ntt_natural_to_rev(i["ntt"])),
        "ntt_batched": np.asarray(ref_ntt.ntt_natural_to_rev(i["ntt_batched"])),
        "merkle": np.asarray(ref_merkle.commit([i["merkle"]]).root_np()),
        "intt": np.asarray(ref_ntt.intt_natural_to_rev(i["intt"])),
        "rev_to_natural": np.asarray(ref_ntt.ntt_rev_to_natural(i["intt"])),
        "lde": np.asarray(ref_ntt.coset_lde(i["lde"], 1, ref_bb.GENERATOR)),
        "fold": np.asarray(fold),
        "fold2": np.asarray(ref_fri.fold_round(np.asarray(fold), 8, ref_bb.GENERATOR ** 2 % P,
                                               i["beta"])),
        "ood": np.asarray(ref_ntt.eval_poly_at_point_ext(i["ood"], i["z"])),
    }


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_repeats_devices_and_lays_out_axes():
    m = mesh.make_mesh(n_shard=4, n_data=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "shard": 4}
    assert m.devices() == [torch.device("cpu")] * 4
    assert len(m.grid) == 2 and m.grid[1] == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        mesh.make_mesh(n_shard=8, n_data=2, devices=["cpu"] * 8)


def test_pod_mesh_and_single_process_multihost():
    mesh.initialize_multihost()          # one process: a no-op
    m = mesh.make_pod_mesh(devices=["cpu"] * 2)
    assert m.shape == {"data": 1, "shard": 2}


def test_default_mesh_and_core_raise_without_a_card():
    no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prover_core(FibonacciAir(), 3)


def test_collectives_route_blocks():
    devs = [torch.device("cpu")] * 4
    parts = [torch.arange(8, dtype=torch.int32).reshape(4, 2) + 100 * s for s in range(4)]
    out = mesh.all_to_all(parts, devs, split_axis=0, concat_axis=1)
    for j in range(4):
        assert torch.equal(out[j], torch.cat([p[j:j + 1] for p in parts], dim=1))
    moved = mesh.ppermute(parts, devs, [(0, 3), (2, 1)])
    assert moved[0] is None and moved[2] is None
    assert torch.equal(moved[3], parts[0]) and torch.equal(moved[1], parts[2])
    x = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    m4 = mesh.make_mesh(4, devices=devs)
    assert torch.equal(mesh.shard_rows(m4, x).gather(), x)
    assert torch.equal(mesh.shard_cols(m4, x.reshape(2, 12)).gather(), x.reshape(2, 12))


# ---------------------------------------------------------------------------
# the sharded functions: the reference's sharded ones and the port's own
# ---------------------------------------------------------------------------


def test_mid_twiddles_equal_reference():
    for log_n1, log_n2, inverse in [(4, 5, False), (5, 5, True), (1, 2, False)]:
        np.testing.assert_array_equal(ns.mid_twiddles_np(log_n1, log_n2, inverse),
                                      ref_ntt._mid_twiddles(log_n1, log_n2, inverse))


@pytest.fixture(scope="module")
def port_single():
    """The port's single-device functions on the same inputs."""
    t = {k: _t(v) for k, v in INPUTS.items() if k != "core_challenges"}
    fold = fri.fold_round(t["fold"], 9, bb.GENERATOR, t["beta"])
    return {
        "ntt": _np(ntt.ntt_natural_to_rev(t["ntt"])),
        "ntt_batched": _np(ntt.ntt_natural_to_rev(t["ntt_batched"])),
        "merkle": merkle.commit([t["merkle"]]).root_np(),
        "intt": _np(ntt.intt_natural_to_rev(t["intt"])),
        "rev_to_natural": _np(ntt.ntt_rev_to_natural(t["intt"])),
        "lde": _np(ntt.coset_lde(t["lde"], 1, bb.GENERATOR)),
        "fold": _np(fold),
        "fold2": _np(fri.fold_round(fold, 8, bb.GENERATOR ** 2 % P, t["beta"])),
        "ood": _np(ntt.eval_poly_at_point_ext(t["ood"], t["z"])),
    }


SHARDED = ["ntt", "ntt_batched", "merkle", "intt", "rev_to_natural", "lde", "fold", "fold2",
           "ood"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_equals_single_device_and_reference(port_sharded, port_single, ref_single,
                                                    name):
    """The port's sharded function (8 logical CPU shards) against the port's
    and the reference's single-device functions."""
    np.testing.assert_array_equal(port_sharded[name], port_single[name])
    np.testing.assert_array_equal(port_sharded[name], ref_single[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", SHARDED + ["core"])
def test_sharded_equals_reference_sharded(port_sharded, ref_sharded, name):
    """The port's sharded function against the reference's on its 8 forced
    host devices (the cases of its test_sharded.py:26-151)."""
    got, want = port_sharded[name], ref_sharded[name]
    for g, w in (zip(got, want) if name == "core" else [(got, want)]):
        np.testing.assert_array_equal(g, w)


def test_four_step_local(ref_single):
    np.testing.assert_array_equal(
        _np(ns.ntt_natural_to_rev_four_step_local(_t(INPUTS["ntt"]))), ref_single["ntt"])


def test_sharded_coset_interpolation_and_row_sharded_input(mesh8):
    """A coset shift on the way in and out, and inputs already sharded by
    rows (the quotient chunks' layout) or by columns."""
    x = _t(INPUTS["lde"])
    want = ntt.interpolate_coset_rev(x, 7)
    for arg in (x, mesh.shard_rows(mesh8, x)):
        c = ns.interpolate_coset_rev_sharded(arg, mesh8, 7)
        np.testing.assert_array_equal(_np(c), _np(want))
    lde = ns.eval_coset_from_rev_sharded(c, 2, 5, mesh8)
    np.testing.assert_array_equal(_np(lde), _np(ntt.eval_coset_from_rev(want, 2, 5)))
    cols = ns.ntt_rev_to_natural_sharded(x, mesh8)        # columns sharded
    np.testing.assert_array_equal(_np(ns.ntt_natural_to_rev_sharded(cols, mesh8)),
                                  _np(ntt.ntt_natural_to_rev(ntt.ntt_rev_to_natural(x))))


def test_fri_fold_on_one_shard():
    cw, beta = _t(INPUTS["fold"]), _t(INPUTS["beta"])
    got = fold_round_sharded(cw, 9, bb.GENERATOR, beta, mesh.make_mesh(1, devices=["cpu"]))
    np.testing.assert_array_equal(_np(got), _np(fri.fold_round(cw, 9, bb.GENERATOR, beta)))


def test_sharded_ood_at_two_points(mesh8):
    c, z, z2 = _t(INPUTS["ood"]), _t(INPUTS["z"]), _t(INPUTS["beta"])
    both = eval_poly_at_points_ext_sharded(c, [z, z2], mesh8)
    for got, point in zip(both, (z, z2)):
        np.testing.assert_array_equal(_np(got), _np(ntt.eval_poly_at_point_ext(c, point)))


# ---------------------------------------------------------------------------
# the prover core
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def core_out():
    trace_m, pvs_m = _core_inputs()
    core = make_prover_core(FibonacciAir(), CORE_LOG_N, StarkConfig(), device="cpu")
    return tuple(_np(x) for x in core(_t(trace_m), pvs_m, *INPUTS["core_challenges"]))


REF_CORE_LOG_N = 3   # the reference's jitted core compiles in about 50 s here at 2^3 rows


def test_prover_core_equals_reference():
    """`make_prover_core` against the reference's jitted core, on the same
    trace, public values and challenges."""
    trace, pvs = FibonacciAir().generate_trace(REF_CORE_LOG_N)
    trace_m = _monty(trace)
    pvs_m = np.array([bb.to_monty_int(v) for v in pvs], dtype=np.uint32)
    core = make_prover_core(FibonacciAir(), REF_CORE_LOG_N, StarkConfig(), device="cpu")
    got = core(_t(trace_m), pvs_m, *INPUTS["core_challenges"])
    ref_core = ref_make_core(RefFibonacciAir(), REF_CORE_LOG_N, RefStarkConfig())
    want = ref_core(jnp.asarray(trace_m), jnp.asarray(pvs_m),
                    *(jnp.asarray(c) for c in INPUTS["core_challenges"]))
    for name, g, w in zip(("trace_root", "quotient_root", "codeword", "folded"), got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)


def test_sharded_prover_core_equals_single_device(port_sharded, core_out):
    for name, got, want in zip(("trace_root", "quotient_root", "codeword", "folded"),
                               port_sharded["core"], core_out):
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_sharded_prover_core_on_two_shards(core_out):
    trace_m, pvs_m = _core_inputs()
    core = make_prover_core_sharded(FibonacciAir(), CORE_LOG_N, StarkConfig(),
                                    mesh.make_mesh(2, devices=["cpu"] * 2))
    for got, want in zip(core(_t(trace_m), pvs_m, *INPUTS["core_challenges"]), core_out):
        np.testing.assert_array_equal(_np(got), want)


def test_sharded_core_refuses_preprocessed_columns():
    from zkvm_prover_tpu_torch.models.rv32_v0 import ProgramAir

    core = make_prover_core_sharded(ProgramAir([]), 4, StarkConfig(),
                                    mesh.make_mesh(2, devices=["cpu"] * 2))
    trace = torch.zeros((16, 1), dtype=bb.DTYPE)
    with pytest.raises(NotImplementedError, match="preprocessed"):
        core(trace, [], *INPUTS["core_challenges"])


# ---------------------------------------------------------------------------
# the proving pool (the reference's test_proving_pool.py)
# ---------------------------------------------------------------------------


def _tasks(n):
    return [ProvingTask(serialized_witness=[json.dumps(
        {"log_n": 5, "x0": i, "x1": i + 1}).encode()], identifier=f"pool-{i}")
        for i in range(n)]


def test_task_roundtrip():
    t = _tasks(1)[0]
    t2 = ProvingTask.from_dict(t.to_dict())
    assert t2.serialized_witness == t.serialized_witness
    assert t2.identifier == t.identifier


def test_pool_without_a_card_raises():
    no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with ProvingPool(max_workers=2):
            pass


@pytest.mark.slow
def test_pool_matches_sequential():
    stark = fast_test_config()
    tasks = _tasks(3)
    with ProvingPool(max_workers=2, device="cpu") as pool:
        proofs = pool.prove_all("fibonacci", tasks, stark)
    assert len(proofs) == 3
    seq_prover = Prover.setup(ProverConfig(app_name="fibonacci", stark=stark, device="cpu"))
    for task, proof in zip(tasks, proofs):
        seq = seq_prover.gen_proof_stark(task)
        # deterministic prover: identical statements and proof bodies
        assert seq.user_pvs_proof == proof.user_pvs_proof
        assert seq.proof == proof.proof
        assert UniversalVerifier.verify_stark_proof_with_vk(
            seq_prover.get_app_vk(), proof, stark, device="cpu")
