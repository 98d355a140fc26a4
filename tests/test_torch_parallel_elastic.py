"""Elastic resume of the port's ZeRO-1 states across rank counts
(tests/test_elastic.py on the port): a state checkpointed under 2 gloo
ranks resumes under 4 and the other way round.

The flat moments are padded to a multiple of the rank count, so the saved
length names the rank count that wrote it (the narrow model here has 9014
parameters: 9014 padded for two ranks, 9016 for four).
``elastic_restore_zero1`` reads that length from the checkpoint's record of
its shapes and re-lays the moments out. Tolerance: none. The restored
parameters and moments equal the saved ones bit for bit, and one further
step from the restored state equals one from an in-memory reshard of the
live state, bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.parallel.distributed import init_distributed
from vae_mdl_tpu_torch.parallel.mesh import make_mesh
from vae_mdl_tpu_torch.parallel.spmd import elastic_restore_zero1, zero1_opt_state
from vae_mdl_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(1)


def _n_pad(n, world):
    return -(-n // world) * world


@pytest.fixture(scope="module", params=[(2, 4), (4, 2)], ids=["2to4", "4to2"])
def elastic(request, tmp_path_factory):
    old, new = request.param
    work = tmp_path_factory.mktemp(f"elastic{old}{new}")
    inputs = {"batch": np.random.default_rng(0).integers(0, 256, (8, 8, 8, 3), dtype=np.uint8),
              "ckpt_dir": str(work / "ck")}
    saved = W.spawn("elastic_save", old, work / "save", inputs)
    restored = W.spawn("elastic_restore", new, work / "restore", inputs)
    return old, new, saved, restored


def test_zero1_elastic_restore_across_rank_counts(elastic):
    old, new, saved, restored = elastic
    mem = saved[0]["mem"]
    n = sum(p.numel() for p in mem["params"].values())
    assert _n_pad(n, old) != _n_pad(n, new)  # else this checks nothing
    # the record names the old padded length, read without a tensor
    assert restored[0]["meta"]["opt_state"]["mu"]["flat"] == torch.Size([_n_pad(n, old)])
    for out in restored:
        got = out["restored"]
        assert got["step"] == 2
        for name, p in mem["params"].items():
            assert torch.equal(got["params"][name], p)
        for key in ("mu", "nu"):
            flat = got["opt_state"][key]["flat"]
            assert flat.numel() == _n_pad(n, new)
            assert torch.equal(flat[:n], mem["opt_state"][key]["flat"][:n])
            assert not flat[n:].any()
        assert got["local_mu"].numel() == _n_pad(n, new) // new


def test_elastic_restore_is_an_in_memory_reshard_for_one_more_step(elastic):
    _, _, _, restored = elastic
    for out in restored:
        (ck, loss_ck), (mem, loss_mem) = out["ck_step"], out["mem_step"]
        assert loss_ck == loss_mem
        assert ck["step"] == mem["step"] == 3
        for name in ck["params"]:
            assert torch.equal(ck["params"][name], mem["params"][name]), name
    for name in restored[0]["ck_step"][0]["params"]:
        assert torch.equal(restored[0]["ck_step"][0]["params"][name],
                           restored[-1]["ck_step"][0]["params"][name])


def test_plain_state_restores_across_rank_counts(elastic):
    """The data-parallel state is whole on every rank: a restore under
    another rank count is the saved state, and training goes on."""
    _, _, saved, restored = elastic
    want = saved[0]["plain"]
    for out in restored:
        assert out["plain"]["step"] == 2
        for name, p in want["params"].items():
            assert torch.equal(out["plain"]["params"][name], p)
        assert np.isfinite(out["plain_loss"])


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", timeout=60)
    yield make_mesh()
    dist.destroy_process_group()


def test_elastic_restore_names_an_unreadable_record(world_of_one, tmp_path):
    """Where the record of the saved shapes cannot be read and the strict
    restore fails, the error says what that means; where the strict restore
    succeeds, its state is returned."""
    mesh = world_of_one
    cfg = W.experiment_of(W.narrow_model())
    _, tx, state = W.setup(cfg)
    state.opt_state = zero1_opt_state(tx, state.params, mesh)

    class NoRecord:
        def __init__(self, fail):
            self.fail = fail

        def metadata_tree(self, tag):
            return None

        def restore(self, target, tag):
            if self.fail:
                raise ValueError("optimizer state of another structure")
            return target

    with pytest.raises(ValueError, match="record of the saved shapes is unreadable"):
        elastic_restore_zero1(NoRecord(fail=True), state, mesh)
    assert elastic_restore_zero1(NoRecord(fail=False), state, mesh) is state

    # a real checkpoint whose meta.json lost its record reads as unreadable
    ck = Checkpointer(str(tmp_path / "ck"), "narrow")
    ck.save(state, "latest")
    assert ck.metadata_tree("latest")["opt_state"]["mu"]["flat"] == torch.Size(
        [state.opt_state["mu"]["flat"].numel()])
    meta = os.path.join(ck.base, "latest", "meta.json")
    with open(meta) as f:
        record = json.load(f)
    del record["shapes"]
    with open(meta, "w") as f:
        json.dump(record, f)
    assert ck.metadata_tree("latest") is None
    assert elastic_restore_zero1(ck, state, mesh, "latest") is state
