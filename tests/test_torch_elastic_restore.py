"""A mesh's train-state checkpoint and its elastic restore (the JAX
package's ``CheckpointManager.restore(sharding_fn=)`` and
``FaultTolerantLoop.resume_or(sharding_fn=)``) on a gloo world of 4 CPU
ranks.

``CheckpointManager.save(specs=, mesh=)`` gathers each leaf whole from the
ranks' blocks (the tensor-parallel layout, ZeRO-1's cut of m and v) and
rank 0 writes the npz of whole arrays that one process writes; the
restore cuts each rank's block under the current mesh's layout
(``launch.steps.state_sharding``).  Cases: the reference's own (an (8, 8)
leaf saved on one mesh, restored onto another, bitwise); whisper-base's
smoke train state with ZeRO-1 saved after one step on (2, 2) and restored
onto (2, 2), (1, 4) and one process: the restored tree's whole digests
bitwise the saved one's, the next step on (2, 2) bitwise the
uninterrupted run's, and on (1, 4) and in one process the mesh step's
gates against one process's uninterrupted run (loss ``rtol=1e-4``, params
``atol=rtol=5e-3``, probabilities bitwise one process's update of the same
params); the int8 error feedback, which is each rank's own, restored onto
the saving mesh only; and the JAX package's restore reading the port's
mesh checkpoint into its own train state.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.configs import get_config as jget_config
from repro.models import whisper as JW
from repro.optim import ec4t as jec4t
from repro_torch import convert
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.launch.train import lm_batch_fn
from repro_torch.models import whisper as W
from repro_torch.optim import ec4t
from repro_torch.optim.grad_compress import GradCompressCfg

ARCH = "whisper-base"
SAVE_MESH = (2, 2)
PARAM_TOL = 5e-3        # tests/test_distributed_equivalence.py:70-74
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """whisper's smoke state (numpy), two global batches of 8 x (16 frames
    + 16 tokens), one process's uninterrupted run (its final params dumped
    under ``ref``) and the (2, 2) ranks' run with ZeRO-1: a step, the save
    to ``ckpt``, then the next step."""
    cfg = get_config(ARCH).smoke()
    params = W.whisper_init(cfg, seed=7, device="cpu")
    state = {"params": convert.tree_to_numpy(params),
             "qstate": convert.tree_to_numpy(qat.build_qstate(params))}
    batches = [lm_batch_fn(cfg, batch=8, seq=16)(i) for i in range(2)]
    root = tmp_path_factory.mktemp("elastic")
    ref, ckpt = str(root / "ref"), str(root / "ckpt")
    one = ranks.elastic_train(cfg, None, batches, str(root / "one"),
                              save=True, device="cpu", out_dir=ref, **state)
    res = world.run(ranks.elastic_train, cfg, SAVE_MESH, batches, ckpt,
                    save=True, **state)
    return {"cfg": cfg, "batches": batches, "ref": ref, "ckpt": ckpt,
            "one": one, "mesh": res, "root": root}


def test_the_references_case_an_8x8_leaf_across_meshes(world, tmp_path):
    """``tests/test_checkpoint.py::test_elastic_restore_across_meshes``:
    an (8, 8) leaf cut ("data", "model") saved on (2, 2) restores onto
    (1, 4) with each rank its new block, bitwise; the npz holds the whole
    leaf, which one process and the JAX package read back."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    spec = ("data", "model")
    d = str(tmp_path)
    world.run(ranks.checkpoint_leaf, w, spec, (2, 2), d, step=5)
    for r in world.run(ranks.checkpoint_leaf, w, spec, (1, 4), d):
        i = r["coords"]["model"]
        np.testing.assert_array_equal(r["w"], w[:, 2 * i:2 * i + 2])
    got, meta = tman.CheckpointManager(d).restore({"w": torch.zeros(8, 8)})
    assert meta["step"] == 5 and meta["mesh"] == {
        "axes": ["data", "model"], "shape": [2, 2]}
    np.testing.assert_array_equal(got["w"].numpy(), w)
    jgot, _ = jman.CheckpointManager(d).restore({"w": np.zeros((8, 8),
                                                               np.float32)})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), w)


def _gates(run, one):
    """A restored run on another mesh (or in one process) against one
    process's uninterrupted run: the loss, and each leaf of its params
    (``ranks.block_errors``' largest |got - want| / (1 + |want|))."""
    np.testing.assert_allclose(run["metrics"][0]["loss"],
                               one["metrics"][0]["loss"], rtol=LOSS_RTOL)
    assert run["param_errors"]
    for name, (err, _, rel) in run["param_errors"].items():
        assert rel <= PARAM_TOL, (name, err)


TARGETS = {"2x2": (2, 2), "1x4": (1, 4), "one process": None}


@pytest.mark.parametrize("target", list(TARGETS))
def test_whisper_state_restores_on_every_mesh(world, saved, target):
    """The restored tree (gathered: its whole digests) is bitwise the
    saved one on every target; the next step on the saving mesh is
    bitwise the uninterrupted run's; on another mesh or in one process it
    meets the mesh step's gates against one process, its probabilities
    bitwise one process's update of the same params."""
    s = saved
    mine = s["mesh"][0]
    assert all(r["saved"] == mine["saved"] for r in s["mesh"])
    if TARGETS[target] is None:
        res = [ranks.elastic_train(s["cfg"], None, s["batches"], s["ckpt"],
                                   device="cpu", ref=s["ref"])]
    else:
        res = world.run(ranks.elastic_train, s["cfg"], TARGETS[target],
                        s["batches"], s["ckpt"], ref=s["ref"])
    for r in res:
        assert r["restored"] == mine["saved"]
        assert r["ckpt_bytes"] == mine["ckpt_bytes"]
        if TARGETS[target] == SAVE_MESH:
            assert r["final"] == mine["final"]
            assert r["metrics"] == s["mesh"][r["rank"]]["metrics"]
        else:
            _gates(r, s["one"])
        if TARGETS[target] is not None:
            assert r["layout"] == "tensor parallel" and r["probs_bitwise"]
        assert r["ecl_launches"] == [0]


def test_error_feedback_is_restored_onto_the_saving_mesh_only(world,
                                                             tmp_path):
    """The int8 error feedback is each rank's residual of its own rows and
    blocks, so a checkpoint keeps it per rank: onto the saving mesh each
    rank gets its own back, bitwise; onto another mesh, or into one
    process, no rank's residual belongs to the new rows and blocks, and
    it is reset to zeros."""
    cfg = get_config(ARCH).smoke()
    params = W.whisper_init(cfg, seed=8, device="cpu")
    state = {"params": convert.tree_to_numpy(params),
             "qstate": convert.tree_to_numpy(qat.build_qstate(params))}
    batches = [lm_batch_fn(cfg, batch=8, seq=16)(i) for i in range(2)]
    gc = GradCompressCfg(min_size=256)
    d = str(tmp_path)
    res = world.run(ranks.elastic_train, cfg, SAVE_MESH, batches, d,
                    save=True, compress=gc, **state)
    assert not any(r["err_zero"] for r in res)
    assert sorted(os.listdir(os.path.join(d, "step_00000001", "err"))) == \
        [f"rank{r}.npz" for r in range(4)]
    back = world.run(ranks.elastic_train, cfg, SAVE_MESH, batches, d,
                     compress=gc)
    for r, b in zip(res, back):
        assert b["err_digests"] == r["err_digests"] and not b["err_zero"]
        assert b["final"] == r["final"]
    for r in world.run(ranks.elastic_train, cfg, (1, 4), batches, d,
                       compress=gc):
        assert r["err_zero"] and r["restored"] == res[0]["saved"]
    one = ranks.elastic_train(cfg, None, batches, d, compress=gc,
                              device="cpu")
    assert one["err_zero"] and one["restored"] == res[0]["saved"]


def test_the_jax_package_restores_a_mesh_checkpoint(saved):
    """The JAX package's ``CheckpointManager.restore`` reads the (2, 2)
    checkpoint into its own whisper train state: every leaf equal to the
    port's one-process restore of it."""
    jcfg = jget_config(ARCH).smoke()
    template = jec4t.init_train_state(JW.whisper_init(jax.random.PRNGKey(0),
                                                      jcfg))
    jstate, meta = jman.CheckpointManager(saved["ckpt"]).restore(template)
    cfg = saved["cfg"]
    one = ec4t.init_train_state(W.whisper_init(cfg, device="cpu"))
    tstate, _ = tman.CheckpointManager(saved["ckpt"]).restore(one)
    want = dict(ranks.named_leaves(convert.tree_to_numpy(tstate)))
    got = dict(ranks.named_leaves(jax.tree_util.tree_map(np.asarray,
                                                         jstate)))
    assert sorted(got) == sorted(want) and meta["step"] == 1
    for name, t in want.items():
        np.testing.assert_array_equal(got[name], t, err_msg=name)
